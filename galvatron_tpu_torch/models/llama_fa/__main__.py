from galvatron_tpu_torch.models.llama_fa import main

if __name__ == "__main__":
    raise SystemExit(main())
