from galvatron_tpu_torch.models.opt import main

if __name__ == "__main__":
    raise SystemExit(main())
