"""Serving runtime: paged KV-cache pools (kvcache), samplers, the
per-module decode streams behind continuous batching (decode), the S2M3
multi-task engine, and the cross-task continuous-batching scheduler
(scheduler.ServeScheduler) behind ``s2m3.Deployment.serve()``.
Generative and encoder traffic share one scheduler: encoder stages
coalesce into cross-task batches, generative heads decode all live
sequences in one batched paged-attention launch per step."""
