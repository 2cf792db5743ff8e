"""The replica fleet: N service processes on one host behind a router.

Port of ``kakveda_tpu/fleet/``:

* :mod:`~kakveda_tpu_torch.fleet.hashring`: the consistent-hash ring
  (blake2b; warn traffic shards by app key).
* :mod:`~kakveda_tpu_torch.fleet.router`: the front router: forwards by
  ring assignment, probes health, ejects, retries reads on the next
  replica; under sharded ownership it scatters warns and merges.
* :mod:`~kakveda_tpu_torch.fleet.gossip`: control-state gossip over the
  bus (``fleet.control``) folded into each replica's own admission
  controller as a pressure input.
* :mod:`~kakveda_tpu_torch.fleet.ownership`: sharded ownership: holders,
  epochs, range migration.
* :mod:`~kakveda_tpu_torch.fleet.supervisor`: spawn, watch and stop the
  replica processes (``python -m kakveda_tpu_torch.cli up --replicas N``).
* :mod:`~kakveda_tpu_torch.fleet.autoscaler`: the elastic policy loop in
  the router (``up --autoscale MIN:MAX``): scale-up on sustained pressure,
  lossless drain on idle, replacement of a dead replica.

Ingest fans in over the at-least-once bus (``gfkb.replicate``): each peer
applies the accepted rows idempotently by event id, and DLQ replay heals
a replica that missed them.
"""

from kakveda_tpu_torch.fleet.hashring import HashRing

__all__ = ["HashRing"]
