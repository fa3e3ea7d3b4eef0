"""Device milliseconds per batch of the latent decoder (the VAE's HDBF
decode, or the triplane decode of each scene)."""


def read(run):
    t = run.trace
    r = t.ranges.get("decoder.decode") if t is not None else None
    return 1e3 * float(r.device_s.sum()) / t.batches if r is not None and len(r.start) else None
