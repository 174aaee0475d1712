from .logging import MetricsLogger, fault_tolerant  # noqa: F401
from .callbacks import TeamsNotifier  # noqa: F401
from .profiling import recorded, span, trace  # noqa: F401
