"""Batched streaming frame server over compiled pipelines (the port's).

The paper's hardware serves continuous pixel streams at line rate; this
package is the software serving layer over the lowering engine
(core/lowering/): an asyncio server (server.py) admits requests through
per-app QoS classes, token-bucket rate limits, and queue-depth load
shedding (admission.py — typed ``Overloaded`` rejections instead of
uniform backpressure stalls), feeds a continuous (rolling) micro-batcher
(batcher.py) that buckets frames by input signature and tops batches up
while the previous batch is in flight, dispatches each batch on a CUDA
stream of its own through pinned host buffers (dispatch.py), so the copy
of batch N+1 overlaps the kernels of batch N, and splits the stacked
frame axis over several devices when asked (sharding.py).  Warmup runs
every (app, signature, pow2-batch) bucket before traffic, the kernels'
first-use builds included; per-app health, latency quantiles, and
batch-occupancy histograms live in health.py together with the replayable
arrival trace that feeds ``repro_torch.hwsim.ingest``.

Entry points: ``HWDesign.serve(config=ServeConfig(...))``,
``serve_design``, and ``python -m repro_torch.serve --status``.  Frames
run on ``device`` "cuda" unless the caller passes another ("cpu" runs the
kernels' plain versions); without a card and without ``device="cpu"``
``register`` raises.
"""
from .admission import (HIGH, LOW, NORMAL, PRIORITIES,  # noqa: F401
                        AdmissionController, Overloaded, QoSPolicy,
                        TokenBucket)
from .batcher import (FrameRequest, MicroBatcher,  # noqa: F401
                      frame_signature, next_pow2, split_frames,
                      stack_frames)
from .dispatch import BatchDispatcher, InflightBatch  # noqa: F401
from .health import (AppHealth, HealthMonitor, ServeTrace,  # noqa: F401
                     TraceEvent, quantiles)
from .server import (FrameServer, ServeConfig, ServeStats,  # noqa: F401
                     serve_design)
from .sharding import (PinnedRing, device_put_batch,  # noqa: F401
                       frame_sharding, pad_frames, shard_frames)
