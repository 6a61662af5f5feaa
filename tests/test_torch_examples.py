"""The PyTorch port's examples run, as tests/test_examples.py runs the JAX
package's: each in a subprocess from the repo root, on the CPU
(``--device cpu``; ``04`` on 4 gloo ranks of the CPU with ``--cpu-mesh``).
``05`` imports ``transformers``, as ``tests/test_torch_convert.py`` does."""

import os
import subprocess
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = [
    ("01_attention_features_torch.py", ["--device", "cpu"]),
    ("03_serve_paged_torch.py", ["--device", "cpu"]),
    ("04_multichip_mesh_torch.py", ["--cpu-mesh"]),
    ("05_import_hf_torch.py", ["--device", "cpu"]),
]


@pytest.mark.parametrize("name,args", EXAMPLES, ids=[e[0] for e in EXAMPLES])
def test_example_runs(name, args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    # transformers (05) then loads neither TensorFlow nor Flax: ~12 s less
    env.update(USE_TF="0", USE_FLAX="0")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", name), *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, (
        f"{name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
    )
    assert "max |" in proc.stdout or "err" in proc.stdout or "greedy" in proc.stdout
