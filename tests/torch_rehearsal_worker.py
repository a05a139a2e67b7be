"""The JAX side of tests/test_torch_parity_rehearsal.py, run in a spawned
process while the test's process runs the port's rehearsals: the JAX
package's whole parity rehearsal (tools/parity_rehearsal.py), whose
printout and table come back.

`init` (the pool's initializer) puts JAX on the CPU, as tests/conftest.py
does, and makes both packages and the tests' helpers importable.
"""

import contextlib
import io
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def init():
    for p in (str(REPO), str(REPO / "tools"), str(REPO / "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    import jax
    jax.config.update("jax_platforms", "cpu")


def jax_rehearsal(workdir: str) -> dict:
    """The JAX package's tools/parity_rehearsal.py `run` in `workdir`:
    {'report': its printout, 'results': the table it returns}."""
    import parity_rehearsal

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = parity_rehearsal.run(workdir)
    return {"report": buf.getvalue(), "results": results}
