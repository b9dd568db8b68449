from .kitti_eval import evaluate_from_files, get_official_eval_result
from .rotate_iou import rotate_iou_eval

__all__ = ["get_official_eval_result", "evaluate_from_files", "rotate_iou_eval"]
