"""Scheduling layers of the port: the arrival/departure/degrade churn
simulator (``churn``). The reference's ``cluster`` and ``serving`` layers
are not ported yet (ROADMAP.md queue 1 item 6, scheduler consumers)."""
from .churn import (TICKABLE_MECHANISMS, VALID_KINDS, ChurnEvent,
                    ChurnRecord, ChurnSimulator, poisson_churn_events)

__all__ = ["TICKABLE_MECHANISMS", "VALID_KINDS", "ChurnEvent", "ChurnRecord",
           "ChurnSimulator", "poisson_churn_events"]
