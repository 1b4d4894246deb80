"""Run a script in ``world`` CPU processes joined by a gloo process group
(a ``file://`` store in a temporary folder): the port's tests of what only
exists across ranks. Each process gets ``RANK``, ``WORLD_SIZE`` and
``INIT_METHOD`` in its environment, imports nothing of jax, and is killed
if the group has not finished within ``timeout`` seconds."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PRELUDE = """
import os, datetime
import torch
import torch.distributed as dist
RANK = int(os.environ["RANK"])
WORLD = int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["INIT_METHOD"],
                        rank=RANK, world_size=WORLD,
                        timeout=datetime.timedelta(seconds=120))
torch.manual_seed(0)
"""

EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""


def run_gloo_ranks(tmp_path: Path, body: str, world: int = 4,
                   timeout: float = 240.0) -> list:
    """Run ``body`` (after the prelude above) on ``world`` ranks; returns
    each rank's (returncode, stderr). Raises ``AssertionError`` with the
    first failure's stderr."""
    script = tmp_path / "rank_script.py"
    script.write_text(PRELUDE + body + EPILOGUE)
    store = tmp_path / "gloo_store"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               WORLD_SIZE=str(world), INIT_METHOD=f"file://{store}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script)], cwd=tmp_path,
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(world)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (code, _, err) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{err[-4000:]}"
    return results
