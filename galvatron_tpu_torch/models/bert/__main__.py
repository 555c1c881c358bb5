from galvatron_tpu_torch.models.bert import main

if __name__ == "__main__":
    raise SystemExit(main())
