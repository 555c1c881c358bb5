from galvatron_tpu_torch.models.swin import main

if __name__ == "__main__":
    raise SystemExit(main())
