from ortools_tpu_torch.flatzinc.driver import main

raise SystemExit(main())
