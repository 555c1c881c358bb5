from galvatron_tpu_torch.models.gpt_fa import main

if __name__ == "__main__":
    raise SystemExit(main())
