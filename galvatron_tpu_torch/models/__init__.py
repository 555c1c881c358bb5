"""Model definition, paged KV-cache forward and tokenizer of the port."""
