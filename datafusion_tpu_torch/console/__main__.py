from datafusion_tpu_torch.console.main import main

raise SystemExit(main())
