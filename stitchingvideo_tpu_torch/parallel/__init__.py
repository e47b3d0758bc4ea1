"""Multi-device compose: canvas row bands over an in-process device mesh,
and multi-host ingest over `torch.distributed`."""
