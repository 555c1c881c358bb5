from galvatron_tpu_torch.models.vit import main

if __name__ == "__main__":
    raise SystemExit(main())
