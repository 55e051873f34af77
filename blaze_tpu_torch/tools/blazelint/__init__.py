"""blazelint — stdlib-ast invariant checkers for the concurrent runtime.

The JAX package's tools/blazelint with every path it names made relative
to one package root (`core.PACKAGE`, `--package`). Run from the repo
root:

    python -m blaze_tpu_torch.tools.blazelint          # lint blaze_tpu_torch/
    python -m blaze_tpu_torch.tools.blazelint --update-baseline
    python -m blaze_tpu_torch.tools.blazelint --package blaze_tpu \
        --baseline LINT_BASELINE.json                  # the JAX package

The baseline of the port is `baseline.json` beside this file. See README
"Static analysis" for the checker catalog and the baseline workflow. The
linter never imports the package it checks (its ``__init__`` pulls in
torch, or jax); sources are parsed, and ``config.py`` is loaded
standalone by file path.
"""

from blaze_tpu_torch.tools.blazelint.core import (  # noqa: F401
    PACKAGE, Checker, Finding, ModuleInfo, RunResult, load_baseline,
    run_checkers, save_baseline)


def default_checkers(root, package=PACKAGE):
    """The six production checkers + the pyflakes-equivalent pass."""
    from blaze_tpu_torch.tools.blazelint.doctor_knob_sync import DoctorKnobSync
    from blaze_tpu_torch.tools.blazelint.hot_path_gating import HotPathGating
    from blaze_tpu_torch.tools.blazelint.knob_registry import KnobRegistry
    from blaze_tpu_torch.tools.blazelint.lock_discipline import LockDiscipline
    from blaze_tpu_torch.tools.blazelint.pyflakes_lite import PyflakesLite
    from blaze_tpu_torch.tools.blazelint.registry_sync import RegistrySync
    from blaze_tpu_torch.tools.blazelint.resource_pairing import \
        ResourcePairing

    return [
        LockDiscipline(package=package),
        KnobRegistry(root=root, package=package),
        ResourcePairing(),
        HotPathGating(package=package),
        RegistrySync(package=package),
        DoctorKnobSync(root=root, package=package),
        PyflakesLite(),
    ]
