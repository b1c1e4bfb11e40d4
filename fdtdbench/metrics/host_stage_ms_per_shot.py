"""Host API layer (stepper._Engine.level, CudaEngine.prepare_state): the
milliseconds a traced shot spends in the program's `stage` spans (a level's
host copy in the storage dtype) and `rims` span (the fast ring's rim
check), their self time: host work in which the card has nothing of the
shot queued. Prints every program span's self time per traced shot and the
ten longest idle gaps named by the benchmark's span and the program's
innermost span."""

import sys

from fdtdbench import program


def read(r):
    sp = program.spans(r)
    if sp is None:
        return None
    per_shot = {n: us * 1e-3 / len(r.traced_shots) for n, us in program.self_us(sp).items()}
    print("fdtdbench: program spans, self ms per traced shot: " + ", ".join(
        f"{n} {ms:.3f}" for n, ms in sorted(per_shot.items(), key=lambda kv: -kv[1])),
        file=sys.stderr)
    captured = {i for i, s in enumerate(r.shots) if s.capture_s}
    print("fdtdbench: idle gaps by program span: " + "; ".join(
        f"{n} {s:.6f} s" for n, s in program.idle_gaps(r, sp, captured)), file=sys.stderr)
    return per_shot.get("stage", 0.0) + per_shot.get("rims", 0.0)
