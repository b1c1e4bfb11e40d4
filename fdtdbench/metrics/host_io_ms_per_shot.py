"""Host API layer (stepper.Simulator.prepare_state / extract_state): the
milliseconds a shot spends in the two calls, each span the benchmark's own
and ending in a synchronize, averaged over the window's shots."""


def read(r):
    spans = [s.prepare_s + s.extract_s for s in r.shots if s.prepare_s is not None]
    return 1e3 * sum(spans) / len(spans) if spans else None
