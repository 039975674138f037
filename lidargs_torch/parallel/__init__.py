"""Data-parallel and multi-process training, and the tile-sharded render:
one process per device, coupled by `torch.distributed` (see `runtime.py`)."""
from .mesh import Mesh, make_mesh
from .runtime import Runtime, RuntimeConfig, frame_schedule, init_runtime, shutdown_runtime
from .shard import DPTrainer, dp_train_step, make_dp_trainer
