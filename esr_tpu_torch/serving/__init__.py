"""The serving tier of the port: continuous-batched lanes over the streaming
engine, and the fleet of replicas behind a router (counterpart of
``esr_tpu/serving``)."""
