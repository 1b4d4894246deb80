"""Scheduling layers of the port on top of the core mechanisms: fleet
batch scheduling (``cluster``), serving-time dispatch (``serving``), and
the arrival/departure/degrade churn simulator (``churn``)."""
from .churn import (TICKABLE_MECHANISMS, VALID_KINDS, ChurnEvent,
                    ChurnRecord, ChurnSimulator, poisson_churn_events)
from .cluster import (Cluster, TenantJob, TPUPod, job_from_artifact,
                      schedule, schedule_detail)
from .serving import (DynamicDispatcher, ReplicaGroup, Tenant,
                      admitted_rates, dispatch_problem)

__all__ = ["TICKABLE_MECHANISMS", "VALID_KINDS", "ChurnEvent", "ChurnRecord",
           "ChurnSimulator", "Cluster", "DynamicDispatcher", "ReplicaGroup",
           "Tenant", "TenantJob", "TPUPod", "admitted_rates",
           "dispatch_problem", "job_from_artifact", "poisson_churn_events",
           "schedule", "schedule_detail"]
