from .evaluate import FpsResult, measure_fps, run_eval
from .losses import (
    LossTerms,
    depth_normals,
    l1_loss,
    l2_loss,
    lidar_losses,
    normal_consistency_loss,
    psnr,
    ssim,
)
from .metrics import eval_ssim, evaluate_frame, mean_metrics
from .optim import AdamState, adam_update, init_adam, lr_schedules
from .schedule import const_lr, expon_lr
from .trainer import (
    StepMetrics,
    Trainer,
    TrainState,
    frame_loss,
    init_train_state,
    loss_and_grads,
    make_optimizer,
    train_step,
)
