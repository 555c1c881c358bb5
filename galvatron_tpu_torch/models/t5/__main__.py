from galvatron_tpu_torch.models.t5 import main

if __name__ == "__main__":
    raise SystemExit(main())
