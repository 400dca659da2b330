from crowdmod_tpu_torch.utils.tracker import RunTracker
from crowdmod_tpu_torch.utils.profiling import StepTimer, trace

__all__ = ["RunTracker", "StepTimer", "trace"]
