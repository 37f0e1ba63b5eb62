from effi_mvs_plus_tpu_torch.eval.dtu import aggregate, evaluate_scan, reduce_pts  # noqa: F401
