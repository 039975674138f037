from .evaluate import FpsResult, measure_fps, run_eval
from .metrics import eval_ssim, evaluate_frame, mean_metrics
