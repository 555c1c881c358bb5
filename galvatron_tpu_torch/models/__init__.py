"""Model definition, KV-cache forwards and generation, and tokenizer of the port."""
