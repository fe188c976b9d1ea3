"""Host build, device build and serving of the port's DISLAND index.

The package splits along the paper's host/device boundary, as the
reference's does: host-side one-shot preprocessing (``bcc``/``agents``/
``partition``/``landmarks``/``supergraph``), host reference engines and
baselines (``engine``/``dijkstra``/``ch``/``arcflags``/``agent_wrap``),
and the device-resident reformulation (``device_engine``/
``dist_engine``/``hierarchy``/``sssp``/``paths``/``refresh_pipeline``)
that serves batched queries as (min,+) algebra over padded tensors.

Exactness rests on the same property as the reference: integer edge
weights keep every float32 (min,+) sum below 2**24, so every table and
every served distance is bit-for-bit equal to the reference's.
"""
