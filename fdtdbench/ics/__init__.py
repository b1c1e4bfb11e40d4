"""Initial wavefields, one generator a file: `make(n, halo, params, rng,
device, planes=None)` gives the padded levels (u_prev, u_cur) as f32
tensors made on `device`: the whole arrays, or with `planes` = (lo, hi)
their padded x planes [lo, hi), equal bit for bit to the whole arrays'. A
traffic mix names its generator by `ic.kind`."""
