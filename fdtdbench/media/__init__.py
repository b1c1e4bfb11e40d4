"""Media, one generator a file: `make(n, halo, params, rng, device)` gives
the padded medium m = 1/c^2 as a float (a uniform medium) or an f32 tensor
made on `device`. A configuration names its generator by `medium.kind`."""
