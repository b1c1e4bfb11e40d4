"""Cells of the benchmark cut to a size a CPU test holds, for the tests."""

from fdtdbench import harness


def tiny(name: str, n: int = 16, root=harness.ROOT) -> harness.Cell:
    """The cell `name` of BENCHMARK.json at n^3, with its shots' steps and
    its limits as committed. The initial field's periods shrink to fit the
    grid, and its amplitude grows as the grid shrinks, (nx / n)^1.5, so
    that its norm, the scale of field_err, stays that of
    the full-size cell beside the sources' fields."""
    cell = harness.load_cell(name, root)
    cell.traffic["ic"]["amp"] *= (cell.config["nx"] / n) ** 1.5
    cell.traffic["ic"]["periods"] = [4.0, 12.0]
    cell.config.update(nx=n, ny=n, nz=n)
    return cell
