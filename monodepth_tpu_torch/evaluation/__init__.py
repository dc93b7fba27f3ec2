from monodepth_tpu_torch.evaluation.eigen import (  # noqa: F401
    depth_errors_np,
    evaluate,
    load_ground_truth,
    predict_disparities,
)
