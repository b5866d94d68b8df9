from deepcharuco_tpu_torch.ops.image import (bgr_to_gray, downsample2x,
                                            normalize_gray, preprocess_bgr)
from deepcharuco_tpu_torch.ops.decode import (
    pred_argmax,
    label_to_keypoints,
    label_to_keypoints_topk,
    pred_to_keypoints,
    pred_to_keypoints_topk,
    heatmap_argmax2d,
    refine_keypoints,
    soft_argmax_2d,
    refine_keypoints_soft,
    refine_keypoints_offset,
)
from deepcharuco_tpu_torch.ops.geom import (
    fill_from_homography,
    pred_to_keypoints_geom,
    reselect_by_homography,
)
from deepcharuco_tpu_torch.ops.heatmap import gaussian_heatmap
from deepcharuco_tpu_torch.ops.patches import extract_patches

__all__ = [
    "bgr_to_gray",
    "downsample2x",
    "normalize_gray",
    "preprocess_bgr",
    "pred_argmax",
    "label_to_keypoints",
    "label_to_keypoints_topk",
    "pred_to_keypoints",
    "pred_to_keypoints_topk",
    "heatmap_argmax2d",
    "refine_keypoints",
    "soft_argmax_2d",
    "refine_keypoints_soft",
    "refine_keypoints_offset",
    "fill_from_homography",
    "pred_to_keypoints_geom",
    "reselect_by_homography",
    "extract_patches",
    "gaussian_heatmap",
]
