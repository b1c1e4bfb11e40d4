"""Initial wavefields, one generator a file: `make(n, halo, params, rng,
device)` gives the padded levels (u_prev, u_cur) as f32 tensors made on
`device`. A traffic mix names its generator by `ic.kind`."""
