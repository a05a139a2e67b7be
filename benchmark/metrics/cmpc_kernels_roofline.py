"""kernels: the least time of the functions the program's `cmpc::` kernels
launched in the traced calls (benchmark/costs/<wrapper>.py at this cell's
shapes, times the program's own launch counts) over the device time of
`cmpc::` kernels in the trace.  Nothing when no such kernel ran."""

import importlib.util

GROUPED = ("spa_affinity_grouped", "graph_update_grouped")


def launch_shape(name, spec, packed):
    """The batch (`bk`, samples of N rows) and weight groups of one launch
    of wrapper `name`: the level-packed graph kernels see the levels'
    samples together."""
    g = spec["levels"] if (name in GROUPED or (name == "graph_msg"
                                                 and packed)) else 1
    return {**spec, "bk": spec["batch"] * g, "groups": g,
            "others": spec["levels"] - 1}


def cost_fn(bench, name):
    path = bench / "costs" / f"{name}.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(f"cost_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.cost


def read(ctx):
    device_s = ctx.trace.kernel_seconds("port")
    if device_s <= 0:
        return None
    packed = any(ctx.launches.get(n, 0) for n in GROUPED)
    least = 0.0
    for name, count in ctx.launches.items():
        fn = cost_fn(ctx.bench, name) if count else None
        if fn is not None:
            least += count * ctx.peaks.least_seconds(
                *fn(launch_shape(name, ctx.spec, packed)))
    return 100.0 * least / device_s
