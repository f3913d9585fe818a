"""Distributed-execution utilities: logical sharding rules, fault-tolerant
serving loops, and elastic rescale planning (the counterpart of
`repro.dist`).

  sharding        — the logical-axis rule tables and `resolve_spec`, over a
                    mesh given as a mapping from axis name to size
  elastic         — `plan_rescale`: keep the global batch (the chip
                    cluster's slot grid) across a change of shard count
  fault_tolerance — `ResilientRunner` (checkpointed replay), the straggler
                    monitor and the scheduler's `FaultTolerance` policy
"""
