"""The port's fault-tolerance control plane (``repro/ft``), a copy of the
reference's numpy module."""
from .failures import (ElasticController, HeartbeatMonitor, RestartEvent,
                       StragglerDetector)

__all__ = ["ElasticController", "HeartbeatMonitor", "RestartEvent",
           "StragglerDetector"]
