"""The port's CLI (`python -m rayforce_tpu_torch -f script.rfl`) prints
the same text as the JAX package's CLI on the verify script of
.claude/skills/verify/SKILL.md (200k rows, 1000 keys: both device
paths run the sort-agg engine). The port runs its device path on CPU
torch (RAYFORCE_DEVICE=cpu), the reference on JAX CPU with its device
path on (RAYFORCE_DEVICE=1)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """\
(set n 200000)
(set t (table [K V P]
    (list (% (til n) 1000) (+ 1 (% (til n) 5)) (as 'F64 (% (til n) 7)))))
(set r (select {c: (count V) s: (sum V) from: t by: K}))
(println "rows: %" (count r))
(show (take r 3))
(set r2 (select {a: (avg P) m: (max V) d: (dev P) from: t by: K
                 where: (> P 2.0)}))
(show (take r2 3))
(println "total: %" (sum (at r 's)))
"""


def _run(pkg, script, env_extra, tmp_path):
    path = tmp_path / f"{pkg}.rfl"
    path.write_text(script)
    env = dict(os.environ, **env_extra)
    r = subprocess.run([sys.executable, "-m", pkg, "-f", str(path)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_cli_matches_reference(tmp_path):
    ref = _run("rayforce_tpu", SCRIPT,
               {"JAX_PLATFORMS": "cpu", "RAYFORCE_PLATFORM": "cpu",
                "RAYFORCE_DEVICE": "1"}, tmp_path)
    port = _run("rayforce_tpu_torch",
                SCRIPT + "(println \"engine: %\" (at (internals) 'engine))\n",
                {"RAYFORCE_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}, tmp_path)
    assert port.endswith("engine: sortagg\n"), port
    assert port[:-len("engine: sortagg\n")] == ref
    assert "rows: 1000" in ref and "total: 600000" in ref
