"""Deterministic fault injection and recovery (counterpart of
``esr_tpu/resilience``): the fault plane (:mod:`.faults`), the recovery
machinery (:mod:`.recovery`: the anomaly guard, bounded retry, checkpoint
integrity, the serving ledgers), the scripted chaos scenario
(:mod:`.chaos`, ``python -m esr_tpu_torch.resilience.chaos``) and the
fleet's (:mod:`.chaos_fleet`, ``python -m
esr_tpu_torch.resilience.chaos_fleet``)."""
