"""The distributed layer of the port: fault injection, the robust
consensus and the compressed consensus wire of the simulated engine, and
the wire's traffic model (counterpart of ``repro.distributed``)."""
