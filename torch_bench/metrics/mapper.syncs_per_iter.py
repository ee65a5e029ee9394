"""The host's blocking CUDA runtime calls (cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize) in the traced window's loop,
ingest and colourise included, per iteration; the calls that torch's
set_sync_debug_mode("warn") reports."""


def read(rec):
    if rec.syncs is None or not rec.iterations:
        return None
    return rec.syncs / rec.iterations
