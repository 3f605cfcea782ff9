"""The distributed layer of the port: fault injection and the robust
consensus of the simulated engine (counterpart of ``repro.distributed``)."""
