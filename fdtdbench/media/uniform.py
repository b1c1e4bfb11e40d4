"""A uniform medium: m = params["m"] everywhere, whatever `planes` asks for."""


def make(n, halo, params, rng, device, planes=None):
    return float(params["m"])
