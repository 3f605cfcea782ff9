"""The distributed layer of the port: fault injection, the robust
consensus, the compressed consensus wire and the robust gradient
aggregation (``grad_compress``), the multi-process harness and the wire's
traffic model (``multihost``), and the logical-axis sharding rules
(``sharding``) (counterpart of ``repro.distributed``)."""
