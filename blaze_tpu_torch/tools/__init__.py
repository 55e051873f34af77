"""The port's command-line tools, each run as
`python -m blaze_tpu_torch.tools.<name>`.

`chaos_soak`, the readers (`trace_report`, `history_report`,
`blaze_doctor`, `blaze_inspect`, `blaze_top`, `blaze_prof`) and the
measurement tools (`pipeline_bench`, `zerocopy_bench`, `perf_baseline`,
`mesh_scaling`, `compile_warm_bench`: the JAX package's `make
check-pipeline`, `check-zerocopy`, `check-perf`/`check-perf-update`/
`check-obs`, its mesh scaling curve and its pre-warm acceptance) are the
JAX package's tools/ scripts over the port's modules: the same functions,
arguments, records and gates. Each takes `--device` (default `cuda`);
without a card and without `--device cpu` it refuses to start, so none of
them carries on quietly on the host. Each writes its JSON only where
`--json-out` says (perf_baseline's baseline is its own file,
`PERF_BASELINE_torch.json` by default). `blazelint` is the static checker,
pointed at `blaze_tpu_torch` by default; it parses sources and runs
nothing.
"""

import sys


def refuse_device(prog: str, device: str) -> bool:
    """True, after saying why on stderr, when `device` cannot be used
    here (a CUDA device asked for on a host without one)."""
    from blaze_tpu_torch.device import resolve_device

    try:
        resolve_device(device)
    except RuntimeError as e:
        print(f"{prog}: {e}; pass --device cpu to run on the host",
              file=sys.stderr)
        return True
    return False
