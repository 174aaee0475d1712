from .logging import MetricsLogger, fault_tolerant  # noqa: F401
