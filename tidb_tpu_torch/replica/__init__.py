"""Elastic read-replica fabric: supervised CDC-fed replica domains
with freshness-SLA routing and zero-error degradation to the leader.

See manager.py for the state machine and docs/ROBUSTNESS.md for the
routing contract.
"""
from .manager import (ReplicaDomain, ReplicaManager, ReplicaSink,
                      STATES)

__all__ = ["ReplicaDomain", "ReplicaManager", "ReplicaSink", "STATES"]
