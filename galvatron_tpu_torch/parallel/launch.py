"""Start a multi-process world on this host under the torchrun environment
contract, with one deadline for all of it.

``launch_local(cmd, world)`` hosts the rendezvous store itself (a
``TCPStore`` on a port the kernel picks, so concurrent worlds never
collide), starts ``world`` copies of ``cmd`` with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``TORCHELASTIC_USE_AGENT_STORE=True`` (every rank connects to the hosted
store as a client, as under torchrun's agent), and waits. A rank that fails
or the deadline ends the others: every process it started (and their
children) is killed before it returns, so a hung rank never outlives the
call.
"""

from __future__ import annotations

import os
import signal
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence


@dataclass
class RankResult:
    rank: int
    returncode: int
    output: str
    killed: bool  # still running at the deadline or after a peer failed


def launch_local(cmd: Sequence[str], world: int, *, timeout_s: float,
                 env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None,
                 local_ranks: Optional[Sequence[int]] = None) -> List[RankResult]:
    """Run ``world`` ranks of ``cmd``; returns each rank's return code and
    its merged stdout/stderr. ``local_ranks[r]`` is rank r's
    ``LOCAL_RANK`` (default r: one card each; equal values share a card)."""
    from torch.distributed import TCPStore

    store = TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    base = dict(os.environ if env is None else env)
    base.update(WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                TORCHELASTIC_USE_AGENT_STORE="True")
    procs, logs = [], []
    try:
        for r in range(world):
            e = dict(base, RANK=str(r),
                     LOCAL_RANK=str(r if local_ranks is None else local_ranks[r]))
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(list(cmd), env=e, cwd=cwd, stdout=log,
                                          stderr=subprocess.STDOUT, start_new_session=True))
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
    finally:
        killed = [p.poll() is None for p in procs]
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            p.wait()
        del store
    out = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        out.append(RankResult(r, p.returncode, log.read(), killed[r]))
        log.close()
    return out
