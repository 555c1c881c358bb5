"""Checkpoint save/restore with resume, atomic and verified (the port's
counterpart of ``galvatron_tpu/core/checkpoint.py``).

The JAX package writes through Orbax, which needs JAX. The port writes its
own format with torch, numpy, ``json``, ``hashlib`` and ``os`` only, and
keeps the reference's commit protocol, names and manifest fields:

1. every leaf of the PORTABLE flat state (the whole model, layers by their
   global index, whatever the plan: :func:`portable_flat_state`) is staged
   as one ``.npy`` file in ``<dir>/step_<n>.tmp/`` and fsynced; a bf16 leaf
   is stored as its ``uint16`` view, with ``bfloat16`` named in the
   manifest;
2. a **manifest** (per-leaf shape / dtype / sha256 content digest, a sha256
   digest and size of every file, and the caller's ``meta``) is written
   into the staging directory *last* and fsynced: it is the commit marker,
   and a directory without a parseable manifest is never a checkpoint;
3. the directory is fsynced and one ``rename(step_<n>.tmp → step_<n>)``
   publishes the step.

Leaf names are the reference's ``jax.tree_util.keystr`` of the flat state
(``['params']['layers'][0]['attn']['wqkv']``, ``['opt']['count']``,
``['step']``, ``['scaler']['scale']``), so ``bridge`` converts the JAX
package's ``portable_flat_state`` leaves name for name; the port does not
read Orbax checkpoints.

A kill at any point leaves either the old committed set untouched or a
``.tmp`` orphan that :func:`latest_step` removes and never selects. Bytes are
verified against the manifest's file digests before a leaf is decoded, the
decoded leaf against its leaf digest. Without an explicit step, a restore
falls back from a corrupt step to the next-older committed one
(``ckpt_fallback`` metrics event; the corrupt step is renamed aside), never
to fresh weights. Saves retry transient I/O (``core/retry.py``) and honour
``keep_last_n``.

Several ranks: every rank calls :func:`save_checkpoint_portable`; rank 0
gathers the pieces (``torch.distributed.gather_object``) and is the one
writer, then a barrier. On restore every rank reads and verifies only the
leaves it holds, the ranks agree on one verdict (an all-reduce) and each
cuts its pieces under the live plan, so a checkpoint restores into any
(pp, vpp, division, tp, ZeRO) layout and world size.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from galvatron_tpu_torch.core.retry import with_retries

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
_STEP_RE = re.compile(r"^step_(\d+)$")
_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")
_TMP_SUFFIX = ".tmp"
_OLD_SUFFIX = ".old"
_IO_THREADS = 8


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed content verification (digest/shape/dtype
    mismatch against its manifest, or an unreadable payload whose structure
    the manifest proves should match)."""


class CheckpointVerificationIOError(CheckpointCorruptError):
    """Verification could not READ the step (transient I/O outlasted the
    retry budget): a reason to fall back to an older step, never to
    quarantine one (a storage outage must not hide healthy checkpoints)."""


# ---------------------------------------------------------------------------
# Step directories
# ---------------------------------------------------------------------------


def parse_step_name(name: str) -> Optional[int]:
    """Strict committed-step-name parser: ``step_<digits>`` only — partial
    saves (``step_N.tmp``), renamed-aside dirs and arbitrary ``step_*``
    artifacts never parse."""
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")


def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The step's manifest, or None when absent/unparseable (uncommitted)."""
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(m, dict) or not isinstance(m.get("leaves"), dict):
        return None
    return m


def gc_stale_tmp(ckpt_dir: str) -> List[str]:
    """Best-effort cleanup of save-protocol leftovers: orphaned staging dirs
    (``step_N.tmp``, a kill mid-save) are removed; a ``step_N.old`` renamed
    aside by an interrupted re-save is renamed BACK when ``step_N`` is
    missing, and removed once the swap is known complete. One writer per
    directory is assumed."""
    removed = []
    if not os.path.isdir(ckpt_dir):
        return removed
    for name in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, name)
        if not os.path.isdir(full):
            continue
        if name.endswith(_OLD_SUFFIX) and parse_step_name(name[: -len(_OLD_SUFFIX)]) is not None:
            final = full[: -len(_OLD_SUFFIX)]
            if os.path.isdir(final):
                shutil.rmtree(full, ignore_errors=True)  # swap completed
                removed.append(full)
            else:
                try:  # the swap died mid-way: put the old committed copy back
                    os.rename(full, final)
                except OSError:
                    pass
        elif name.startswith("step_") and name.endswith(_TMP_SUFFIX):
            shutil.rmtree(full, ignore_errors=True)
            removed.append(full)
    return removed


def _scan_steps(ckpt_dir: str, with_manifest: bool) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        s = parse_step_name(name)
        if s is None:
            continue
        full = os.path.join(ckpt_dir, name)
        if os.path.isdir(full) and (read_manifest(full) is not None) == with_manifest:
            steps.append(s)
    return sorted(steps)


def committed_steps(ckpt_dir: str) -> List[int]:
    """Ascending step numbers whose directories are committed (strict name
    AND a parseable manifest, the commit marker)."""
    return _scan_steps(ckpt_dir, with_manifest=True)


def uncommitted_steps(ckpt_dir: str) -> List[int]:
    """Step-named directories with NO manifest (partial writes): callers
    that find no committed steps surface these instead of silently starting
    from scratch."""
    return _scan_steps(ckpt_dir, with_manifest=False)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest committed step (stale ``.tmp`` staging dirs are removed on the
    way); None when no committed checkpoint exists."""
    gc_stale_tmp(ckpt_dir)
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _no_checkpoints_message(ckpt_dir: str) -> str:
    legacy = uncommitted_steps(ckpt_dir)
    if legacy:
        return (f"no committed checkpoints under {ckpt_dir} — but steps {legacy} exist "
                "without a manifest (partial writes); restore one explicitly with step=N")
    return f"no checkpoints under {ckpt_dir}"


# ---------------------------------------------------------------------------
# Leaves, digests, manifest
# ---------------------------------------------------------------------------


def keystr(path) -> str:
    """The reference's ``jax.tree_util.keystr`` of a path of dict keys
    (str) and list indices (int)."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']" for p in path)


def parse_keystr(key: str) -> Tuple:
    """:func:`keystr`'s inverse."""
    parts = tuple(m.group(1) if m.group(2) is None else int(m.group(2))
                  for m in _KEY_RE.finditer(key))
    if keystr(parts) != key:
        raise ValueError(f"not a leaf key: {key!r}")
    return parts


def flatten(tree, prefix: Tuple = ()) -> Dict[str, Any]:
    """``{keystr: leaf}`` of a tree of dicts (keys sorted) and lists (a
    tuple is a leaf: a shape)."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, prefix + (i,)))
        return out
    return {keystr(prefix): tree}


def unflatten(flat: Dict[str, Any]) -> Any:
    """The tree of :func:`flatten` (integer keys become lists)."""
    root: Dict[Any, Any] = {}
    for key, leaf in flat.items():
        parts = parse_keystr(key)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [listify(node[i]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _file_name(key: str) -> str:
    return ".".join(str(p) for p in parse_keystr(key)) + ".npy"


def to_storage(leaf) -> Tuple[np.ndarray, str]:
    """(contiguous numpy array as stored, logical dtype name) of a tensor,
    array or Python scalar; bf16 becomes its ``uint16`` view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return _c_order(t.cpu().view(torch.int16).numpy().view(np.uint16)), "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    arr = _c_order(arr)
    return arr, str(arr.dtype)


def _c_order(arr: np.ndarray) -> np.ndarray:
    # not np.ascontiguousarray: it turns a 0-d array into shape (1,)
    return arr if arr.flags.c_contiguous else arr.copy(order="C")


def from_storage(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """:func:`to_storage`'s inverse: a CPU tensor of the logical dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _raw(arr: np.ndarray) -> np.ndarray:
    """A C-contiguous array's bytes, as a flat uint8 view (no copy)."""
    return arr.reshape(-1).view(np.uint8)


def _digest(arr: np.ndarray) -> str:
    return "sha256:" + hashlib.sha256(_raw(arr)).hexdigest()


def _leaf_digest(arr: np.ndarray, dtype: str) -> Dict[str, Any]:
    return {"shape": list(arr.shape), "dtype": dtype, "digest": _digest(arr)}


def _file_digest(path: str) -> Dict[str, Any]:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return {"size": os.path.getsize(path), "digest": "sha256:" + h.hexdigest()}


def _bytes_digest(data) -> Dict[str, Any]:
    return {"size": len(data), "digest": "sha256:" + hashlib.sha256(data).hexdigest()}


def _file_error(rel: str, want: Optional[Dict[str, Any]], got: Optional[Dict[str, Any]]
                ) -> Optional[str]:
    """What is wrong with one file against its manifest record, or None."""
    if want is None:
        return f"unexpected file {rel}"
    if got is None:
        return f"missing file {rel}"
    if got["size"] != want.get("size"):
        return f"file {rel} size mismatch ({got['size']} bytes, manifest records {want.get('size')})"
    if got != want:
        return f"file {rel} content digest mismatch (size {got['size']} matches — bytes corrupted in place)"
    return None


def _file_digests(root: str) -> Dict[str, Dict[str, Any]]:
    """sha256 + size of every file under a step directory (manifest
    excluded): the pre-decode integrity record."""
    out: Dict[str, Dict[str, Any]] = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn == MANIFEST_NAME:
                continue
            full = os.path.join(dirpath, fn)
            out[os.path.relpath(full, root)] = _file_digest(full)
    return out


def verify_files(path: str, manifest: Dict[str, Any]) -> List[str]:
    """Raw-byte verification of a whole step directory against its
    manifest's file records (the restores check each file the same way as
    they read it, before decoding it)."""
    want = manifest.get("files")
    if not want:
        return []
    got = _file_digests(path)
    errs = [_file_error(rel, want.get(rel), got.get(rel)) for rel in sorted(set(want) | set(got))]
    return [e for e in errs if e]


def verify_manifest(manifest: Dict[str, Any], flat: Dict[str, Tuple[np.ndarray, str]]
                    ) -> List[str]:
    """Per-leaf shape/dtype/content-digest check of restored leaves
    (``{key: (stored array, dtype)}``) against the manifest."""
    errs: List[str] = []
    want = manifest.get("leaves", {})
    for k, (arr, dtype) in flat.items():
        rec = want.get(k)
        if rec is None:
            errs.append(f"leaf {k} not in manifest")
            continue
        got = _leaf_digest(arr, dtype)
        for fld in ("shape", "dtype", "digest"):
            if got[fld] != rec.get(fld):
                errs.append(f"leaf {k} {fld} mismatch: checkpoint has {got[fld]}, manifest "
                            f"records {rec.get(fld)}")
                break
    return errs


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # not every filesystem exposes dir fds; rename is still atomic
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _apply_retention(ckpt_dir: str, keep_last_n: int) -> None:
    for s in committed_steps(ckpt_dir)[:-keep_last_n]:
        shutil.rmtree(step_path(ckpt_dir, s), ignore_errors=True)


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------


def _write_leaf(tmp: str, key: str, leaf) -> Tuple[str, Dict[str, Any], str, Dict[str, Any]]:
    """One leaf's ``.npy`` (format 1.0: the header, then the C-order bytes)
    written and fsynced; its manifest records, the file's digest taken from
    the bytes written rather than a second read."""
    arr, dtype = to_storage(leaf)
    header = io.BytesIO()
    np.lib.format.write_array_header_1_0(header, np.lib.format.header_data_from_array_1_0(arr))
    data = _raw(arr)
    rel = _file_name(key)
    with open(os.path.join(tmp, rel), "wb") as f:
        f.write(header.getbuffer())
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    h = hashlib.sha256(header.getbuffer())
    h.update(data)
    frec = {"size": len(header.getbuffer()) + len(data), "digest": "sha256:" + h.hexdigest()}
    return key, _leaf_digest(arr, dtype), rel, frec


def save_checkpoint(ckpt_dir: str, flat: Dict[str, Any], step: int, keep_last_n: int = 0,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``flat`` (``{keystr: tensor | array | scalar}``) as
    ``ckpt_dir/step_<step>`` under the commit protocol; transient I/O is
    retried (the data write and the commit separately); ``keep_last_n > 0``
    prunes older committed steps after the new one lands. ``meta``
    (JSON-serialisable) rides in the manifest."""
    base = os.path.abspath(ckpt_dir)
    final = os.path.join(base, f"step_{step}")
    tmp = final + _TMP_SUFFIX
    manifest: Dict[str, Any] = {"version": MANIFEST_VERSION, "step": int(step), "leaves": {}}
    if meta:
        manifest["meta"] = dict(meta)
    files: Dict[str, Dict[str, Any]] = {}

    def write_data():
        os.makedirs(base, exist_ok=True)
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            for key, rec, rel, frec in pool.map(lambda kv: _write_leaf(tmp, *kv),
                                                 sorted(flat.items())):
                manifest["leaves"][key] = rec
                files[rel] = frec

    def commit():
        manifest["files"] = dict(sorted(files.items()))
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.isdir(final):
            # a re-save of an existing step swaps through a recoverable .old
            old = final + _OLD_SUFFIX
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final)
        _fsync_dir(base)

    # two retry units: a transient failure in the small commit must not
    # re-run the data write
    with_retries(write_data, describe=f"checkpoint save step {step}")
    with_retries(commit, describe=f"checkpoint commit step {step}")
    if keep_last_n > 0:
        _apply_retention(base, keep_last_n)
    return final


# ---------------------------------------------------------------------------
# The portable flat state of a runtime
# ---------------------------------------------------------------------------


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _held_keys(runtime) -> Dict[str, Any]:
    """This rank's held parameter tree with each leaf replaced by its
    global key within the params (``['layers'][i]...`` with the global
    layer index)."""
    from galvatron_tpu_torch.parallel import pipeline

    return pipeline.held_tree(_key_tree(runtime.leaf_plans, ()), runtime.stage_layers,
                              runtime.stage == 0, runtime.stage == runtime.pp - 1,
                              runtime.cfg.tie_word_embeddings and runtime.pp > 1)


def _key_tree(tree, prefix):
    """``tree``'s structure with each leaf replaced by its key."""
    if isinstance(tree, dict):
        return {k: _key_tree(v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_key_tree(v, prefix + (i,)) for i, v in enumerate(tree)]
    return keystr(prefix)


_PARAMS, _MU, _NU = keystr(("params",)), keystr(("opt", "mu")), keystr(("opt", "nu"))


def _pieces(runtime, state) -> Dict[str, Dict[str, Any]]:
    """This rank's pieces by global key: params / mu / nu (CPU tensors)."""
    from galvatron_tpu_torch.core.optim import tree_leaves

    keys = tree_leaves(_held_keys(runtime))
    out: Dict[str, Dict[str, Any]] = {}
    for part, tree in (("params", state["params"]), ("mu", state["opt"]["mu"]),
                       ("nu", state["opt"]["nu"])):
        for key, t in zip(keys, tree_leaves(tree)):
            out.setdefault(key, {})[part] = t.detach().to("cpu")
    return out


def _scalars(runtime, state) -> Dict[str, Any]:
    """The replicated scalar leaves, under the reference's names and dtypes."""
    out = {keystr(("opt", "count")): torch.tensor(int(state["opt"]["count"]), dtype=torch.int32),
           keystr(("step",)): torch.tensor(int(state["step"]), dtype=torch.int32)}
    if "scaler" in state:
        for k, v in state["scaler"].items():
            out[keystr(("scaler", k))] = v.detach().to("cpu")
    return out


def _plan_of(runtime, key: str):
    node = runtime.leaf_plans
    for p in parse_keystr(key):
        node = node[p]
    return node


def portable_flat_state(state: Dict[str, Any], runtime) -> Optional[Dict[str, Any]]:
    """The PORTABLE flat view of a train state: ``{keystr: CPU tensor}`` of
    the whole model's params and Adam moments (full shapes, layers by global
    index), ``['opt']['count']``, ``['step']`` and, under fp16, the scaler.
    Collective over the world: rank 0 gets the tree, the others None."""
    from galvatron_tpu_torch.parallel.mesh import RankMesh
    from galvatron_tpu_torch.parallel.sharding import unshard

    dist = _dist()
    mine = _pieces(runtime, state)
    world = runtime.world
    if world == 1 or dist is None:
        ranks = [mine]
    else:
        ranks = [None] * world if runtime.rank == 0 else None
        dist.gather_object(mine, ranks, dst=0)
        if runtime.rank != 0:
            return None
    mesh = runtime.mesh
    stage_mesh = RankMesh(mesh.per_stage)
    flat: Dict[str, Any] = {}
    for key in sorted({k for r in ranks for k in r}):
        lp = _plan_of(runtime, key)
        # the lowest stage that holds it (a tied table: stage 0's copy)
        stage = next(st for st in range(runtime.pp)
                     if key in ranks[mesh.stage_ranks(st)[0]])
        for part, layout in (("params", lp.layout), ("mu", lp.opt_layout),
                             ("nu", lp.opt_layout)):
            pieces = [ranks[r][key][part] for r in mesh.stage_ranks(stage)]
            if all(ax is None for ax in layout) or len(pieces) == 1:
                full = pieces[0]
            else:
                full = torch.from_numpy(unshard([p.numpy() for p in pieces], layout, lp.shape,
                                                stage_mesh, lp.pairs))
            flat[{"params": _PARAMS, "mu": _MU, "nu": _NU}[part] + key] = full
    flat.update(_scalars(runtime, state))
    return flat


def save_checkpoint_portable(ckpt_dir: str, state: Dict[str, Any], step: int, runtime,
                             keep_last_n: int = 0, meta: Optional[Dict[str, Any]] = None
                             ) -> Optional[str]:
    """Save the portable flat state of ``state``: collective over the
    world, rank 0 writes, every rank returns after the commit (the path on
    rank 0, None elsewhere)."""
    flat = portable_flat_state(state, runtime)
    path = None
    err: Optional[BaseException] = None
    if flat is not None:
        try:
            path = save_checkpoint(ckpt_dir, flat, step, keep_last_n=keep_last_n, meta=meta)
        except BaseException as e:  # noqa: BLE001 — every rank must learn of it
            err = e
    _agree(runtime, err is not None, "checkpoint save failed on rank 0")
    if err is not None:
        raise err
    return path


def _agree(runtime, failed: bool, what: str) -> None:
    """One verdict over the world: raise on every rank when any rank failed."""
    dist = _dist()
    if dist is None or runtime.world == 1:
        return
    from galvatron_tpu_torch.parallel import comm

    flag = torch.tensor(float(failed), device=runtime.device)
    comm.all_reduce(flag, runtime.groups.get(runtime.mesh.world_axes))
    if float(flag) and not failed:
        raise CheckpointCorruptError(what)


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


def _decode(data: bytes) -> np.ndarray:
    """A ``.npy`` file's array, read-only over ``data`` (no copy)."""
    f = io.BytesIO(data)
    version = np.lib.format.read_magic(f)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(f)
    arr = np.frombuffer(data, dtype=dtype, offset=f.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


def _read_verified(path: str, step: int, manifest: Dict[str, Any], keys: List[str],
                   where: str) -> Dict[str, Tuple[np.ndarray, str]]:
    """The leaves ``keys`` of a step, each read once (in parallel): its file's
    bytes held to the manifest's file record before they are decoded, the
    decoded leaf to its leaf record. Corruption raises
    :class:`CheckpointCorruptError`, a file still unreadable after retries
    :class:`CheckpointVerificationIOError`."""
    leaves, files = manifest["leaves"], manifest.get("files") or {}

    def corrupt(what):
        return CheckpointCorruptError(f"step {step} under {where} failed {what}")

    def load(key):
        rel = _file_name(key)

        def read():
            with open(os.path.join(path, rel), "rb") as f:
                return f.read()

        try:
            data = with_retries(read, describe=f"read {rel}")
        except FileNotFoundError:
            raise corrupt(f"file verification: missing file {rel}") from None
        err = _file_error(rel, files.get(rel), _bytes_digest(data)) if files else None
        if err:
            raise corrupt(f"file verification: {err}")
        try:
            arr = _decode(data)
        except ValueError as e:
            raise corrupt(f"to decode {rel}: {str(e)[:200]}") from e
        errs = verify_manifest(manifest, {key: (arr, leaves[key]["dtype"])})
        if errs:
            raise corrupt("content verification: " + "; ".join(errs))
        return key, arr

    try:
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            raw = dict(pool.map(load, keys))
    except OSError as e:
        raise CheckpointVerificationIOError(
            f"step {step} under {where} could not be read after retries: {str(e)[:300]}") from e
    return {k: (raw[k], leaves[k]["dtype"]) for k in keys}


def _expected_keys(runtime, scaler: bool) -> List[str]:
    from galvatron_tpu_torch.core.optim import tree_leaves

    paths = tree_leaves(_key_tree(runtime.leaf_plans, ()))
    keys = [pre + p for pre in (_PARAMS, _MU, _NU) for p in paths]
    keys += [keystr(("opt", "count")), keystr(("step",))]
    if scaler:
        keys += [keystr(("scaler", "good_steps")), keystr(("scaler", "scale"))]
    return keys


def _restore_portable_at(ckpt_dir: str, runtime, step: int) -> Dict[str, Any]:
    from galvatron_tpu_torch.core.optim import tree_leaves

    base = os.path.abspath(ckpt_dir)
    path = step_path(base, step)
    manifest = read_manifest(path)
    if manifest is None:
        raise FileNotFoundError(f"step_{step} under {base} has no manifest (not committed)")
    fp16 = runtime.scaler_cfg is not None
    want = set(_expected_keys(runtime, fp16))
    have = set(manifest["leaves"])
    if want != have:
        missing, extra = sorted(want - have), sorted(have - want)
        scaler_only = all(parse_keystr(k)[0] == "scaler" for k in missing + extra)
        raise ValueError(
            f"checkpoint step {step} under {base} does not fit this model: {len(missing)} "
            f"leaves missing (e.g. {missing[:3]}), {len(extra)} unexpected (e.g. {extra[:3]})"
            + ("; only the fp16 loss scaler differs: resume with the --mixed_precision the "
               "checkpoint was trained with" if scaler_only else ""))
    held = _held_keys(runtime)
    keys = [pre + p for pre in (_PARAMS, _MU, _NU) for p in tree_leaves(held)]
    keys += [k for k in sorted(want) if parse_keystr(k)[0] in ("step", "scaler")
             or k == keystr(("opt", "count"))]
    err: Optional[BaseException] = None
    flat: Dict[str, Tuple[np.ndarray, str]] = {}
    try:
        flat = _read_verified(path, step, manifest, keys, base)
    except CheckpointCorruptError as e:
        err = e
    _agree(runtime, err is not None, f"step {step} under {base} failed verification on "
           "another rank")
    if err is not None:
        raise err
    return restore_from_flat_leaves(runtime, {k: from_storage(*v) for k, v in flat.items()})


def restore_from_flat_leaves(runtime, leaves: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A train state of ``runtime`` (this rank's pieces on its device) from
    portable flat leaves (``{keystr: CPU tensor}``: a checkpoint's, or the
    JAX package's ``portable_flat_state`` through ``bridge``); only the
    leaves this rank holds are read."""
    from galvatron_tpu_torch.core.optim import tree_leaves
    from galvatron_tpu_torch.parallel.hybrid import zip_map
    from galvatron_tpu_torch.parallel.sharding import shard

    mesh, rank, device = runtime.mesh, runtime.rank, runtime.device
    held = _held_keys(runtime)

    def piece(prefix, layout_of):
        def leaf(key, lp, name):
            t = shard(leaves[prefix + key], layout_of(lp), mesh, rank, lp.pairs)
            return t.to(device=device, dtype=torch.float32).contiguous()
        return leaf

    held_plans = zip_map(lambda key, n: _plan_of(runtime, key), held)
    state = runtime.state_from(zip_map(piece(_PARAMS, lambda lp: lp.layout), held, held_plans))
    for m, pre in (("mu", _MU), ("nu", _NU)):
        got = zip_map(piece(pre, lambda lp: lp.opt_layout), held, held_plans)
        for dst, src in zip(tree_leaves(state["opt"][m]), tree_leaves(got)):
            dst.copy_(src)
    state["opt"]["count"] = int(leaves[keystr(("opt", "count"))])
    state["step"] = int(leaves[keystr(("step",))])
    if runtime.scaler_cfg is not None:
        state["scaler"] = {"scale": leaves[keystr(("scaler", "scale"))].to(device, torch.float32),
                           "good_steps": leaves[keystr(("scaler", "good_steps"))].to(
                               device, torch.int32)}
    return state


def _try_newest_first(steps, restore_one, exhausted_msg: str, metrics=None,
                      quarantine_base: Optional[str] = None, writer: bool = True):
    """THE fallback protocol of every no-explicit-step restore: try
    ``restore_one(step)`` newest → oldest, skipping steps that fail
    verification (a ``ckpt_fallback`` metrics event each); raise
    :class:`CheckpointCorruptError` once every candidate failed. With
    ``quarantine_base`` (the trainer's resume), a corrupt step is renamed
    aside (``step_N.corrupt``) by the ``writer`` so it stops counting as
    committed."""
    last_err: Optional[CheckpointCorruptError] = None
    for s in steps:
        try:
            return restore_one(s)
        except CheckpointCorruptError as e:
            if writer:
                print(f"checkpoint step {s} corrupt, falling back: {str(e)[:200]}", flush=True)
            if metrics is not None:
                metrics.log("ckpt_fallback", step=s, error=str(e)[:300])
            if quarantine_base is not None and writer and not isinstance(
                    e, CheckpointVerificationIOError):
                _quarantine_step(quarantine_base, s)
            last_err = e
    raise CheckpointCorruptError(exhausted_msg) from last_err


def _quarantine_step(base: str, s: int) -> None:
    """Rename a corrupt committed step aside (``step_N`` → ``step_N.corrupt``,
    kept for forensics) so name-based selection and retention never see it
    again."""
    src = step_path(base, s)
    dst = src + ".corrupt"
    for _ in range(2):
        try:
            os.rename(src, dst)
            print(f"quarantined corrupt checkpoint {src} → {dst}", flush=True)
            return
        except OSError:
            if not os.path.isdir(src):
                return
            if os.path.isdir(dst):
                shutil.rmtree(dst, ignore_errors=True)  # a stale quarantine: retry once
            else:
                return


def restore_checkpoint_portable(ckpt_dir: str, runtime, step: Optional[int] = None,
                                metrics=None) -> Dict[str, Any]:
    """Restore a portable checkpoint into the runtime's own layout (this
    rank's pieces under its plan, on its device). Without ``step``,
    committed steps are tried newest → oldest (:func:`_try_newest_first`).
    Collective over the world."""
    if step is not None:
        return _restore_portable_at(ckpt_dir, runtime, step)
    writer = runtime.rank == 0
    if writer:
        gc_stale_tmp(ckpt_dir)
    steps = committed_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(_no_checkpoints_message(ckpt_dir))
    return _try_newest_first(
        list(reversed(steps)), lambda s: _restore_portable_at(ckpt_dir, runtime, s),
        f"all {len(steps)} committed checkpoints under {ckpt_dir} failed verification",
        metrics=metrics if writer else None, quarantine_base=os.path.abspath(ckpt_dir),
        writer=writer)


def _restore_raw_at(base: str, s: int, prefix: str) -> Dict[str, Any]:
    path = step_path(base, s)
    manifest = read_manifest(path)
    if manifest is None:
        raise CheckpointCorruptError(f"step {s} under {base} has no manifest")
    keys = sorted(k for k in manifest["leaves"] if k.startswith(prefix))
    flat = _read_verified(path, s, manifest, keys, base)
    return unflatten({k: from_storage(a, d) for k, (a, d) in flat.items()})


def restore_raw_checkpoint(ckpt_dir: str, step: Optional[int] = None, prefix: str = "") -> tuple:
    """Raw (no runtime) restore of a step as a tree of CPU tensors, verified,
    with the same newest-to-oldest fallback as the portable path: the
    model-only consumers' (``cli serve --load``). ``prefix`` keeps the
    leaves whose keys start with it (``"['params']"``: the weights alone;
    only their files are read and verified). Returns ``(tree, step)``."""
    base = os.path.abspath(ckpt_dir)
    if step is not None:
        if not os.path.isdir(step_path(base, step)):
            raise FileNotFoundError(f"no step_{step} under {base}")
        return _restore_raw_at(base, step, prefix), step
    gc_stale_tmp(base)
    steps = list(reversed(committed_steps(base)))
    if not steps:
        raise FileNotFoundError(_no_checkpoints_message(base))
    return _try_newest_first(
        steps, lambda s: (_restore_raw_at(base, s, prefix), s),
        f"all {len(steps)} candidate checkpoints under {base} failed verification")
