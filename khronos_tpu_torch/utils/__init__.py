from khronos_tpu_torch.utils.timing import Timer, TimingRecorder
from khronos_tpu_torch.utils.logging import ExperimentLogger, setup_output_directory

__all__ = ["Timer", "TimingRecorder", "ExperimentLogger", "setup_output_directory"]
