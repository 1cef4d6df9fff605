"""Serving fleet — the port of ``paddle_tpu/fleet/``: a KV-aware,
prefix-affine router over N ``cli.py serve`` replicas with exactly-once
mid-stream failover, plus the autopilot that resizes, deploys and
keeps the router plane HA. Host code only: every replica runs its
decode engine (and the window kernel) in its own process.

- fleet/registry.py  — replica membership on the coordinator plane
  (lease expiry = implicit drain; rejoin = re-admit; coordinator
  OUTAGE = bounded-staleness last-known view, not a mass leave)
- fleet/balance.py   — aggregate-KV-headroom admission + the radix
  prefix-affinity index (serving/prefix.py's keying, router-side) +
  rendezvous hashing so N independent routers agree on placement
- fleet/router.py    — dispatch, queueing, drain/deploy, mid-stream
  failover with trace-id continuity
- fleet/autopilot.py — the autoscaler (shed-rate / KV-headroom / SLO
  signals through a hysteresis policy into a pluggable provisioner)
  and the SLO-gated rolling deploy
- fleet/http.py      — the ``cli.py router`` daemon's HTTP front
  (streaming NDJSON relay + /admin/deploy + /admin/scale)
- fleet/obs.py       — paddle_tpu_fleet_* / paddle_tpu_autopilot_*
  exposition + flight state

testing/faults.py families (p)/(q) (``kill_replica``,
``lease_lapse``, ``drain_during_burst``, ``kill_router``,
``coordinator_outage``) are the chaos coverage.
"""

from paddle_tpu_torch.fleet.autopilot import (Autopilot, AutopilotPolicy,
                                              CallbackProvisioner,
                                              ReplicaProvisioner,
                                              RollingDeploy,
                                              SubprocessProvisioner)
from paddle_tpu_torch.fleet.balance import (AffinityIndex, FleetBalancer,
                                            ReplicaState, rendezvous_choose,
                                            stable_prefix_key)
from paddle_tpu_torch.fleet.http import build_router_http_server
from paddle_tpu_torch.fleet.registry import (Registration,
                                             ReplicaRegistration,
                                             ReplicaRegistry, ReplicaView)
from paddle_tpu_torch.fleet.router import FleetResult, Router

__all__ = [
    "AffinityIndex", "Autopilot", "AutopilotPolicy",
    "CallbackProvisioner", "FleetBalancer", "FleetResult",
    "Registration", "ReplicaProvisioner", "ReplicaRegistration",
    "ReplicaRegistry", "ReplicaState", "ReplicaView", "RollingDeploy",
    "Router", "SubprocessProvisioner", "build_router_http_server",
    "rendezvous_choose", "stable_prefix_key",
]
