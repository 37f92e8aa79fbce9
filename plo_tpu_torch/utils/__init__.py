"""Profiling, evaluation, checkpoints and the artifact saver."""
from plo_tpu_torch.utils.profiling import TicToc, MetricsLog, DeviceTrace  # noqa: F401
from plo_tpu_torch.utils.evaluate import ate_rmse, rpe, align_umeyama  # noqa: F401
