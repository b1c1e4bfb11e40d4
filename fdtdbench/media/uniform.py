"""A uniform medium: m = params["m"] everywhere."""


def make(n, halo, params, rng, device):
    return float(params["m"])
