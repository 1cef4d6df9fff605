"""Core of the port: data types, sequence batches, the layer registry
and the Topology executor (counterparts of ``paddle_tpu/core``)."""
