"""Deterministic fault injection and recovery (counterpart of
``esr_tpu/resilience``): the fault plane (:mod:`.faults`), the recovery
telemetry and serving ledgers (:mod:`.recovery`), and the scripted fleet
chaos scenario (:mod:`.chaos_fleet`, ``python -m
esr_tpu_torch.resilience.chaos_fleet``)."""
