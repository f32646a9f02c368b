"""Traffic kind "batch": one caller hands whole files to
libhm_tpu_torch.parallel.dag_decode.decode_batch, back to back; each call
returns the file's pictures in output order, downloaded to host memory."""


def decode(ctx, data):
    from libhm_tpu_torch.parallel.dag_decode import decode_batch
    pictures = decode_batch(data, device=ctx.device)
    return [[list(pic) for pic in pictures]], {}
