"""Media, one generator a file: `make(n, halo, params, rng, device,
planes=None)` gives the padded medium m = 1/c^2 as a float (a uniform
medium) or an f32 tensor made on `device`: the whole array, or with
`planes` = (lo, hi) its padded x planes [lo, hi), equal bit for bit to the
whole array's. A configuration names its generator by `medium.kind`."""
