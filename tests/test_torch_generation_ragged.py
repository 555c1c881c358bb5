"""Ragged prompts, teacher-forced through the port's contiguous, slot-wise
and paged cache forwards against the JAX package, per family; split from
``tests/test_torch_generation.py`` (whose helpers it uses) so that the
suite's workers can share the two files."""

import numpy as np

from galvatron_tpu.models import generation as jgen
from galvatron_tpu_torch.models import generation as tgen
from test_torch_generation import family  # noqa: F401 — the fixture, per family
import _torch_threads  # noqa: F401


def test_ragged_prompts_teacher_forced(family):
    """Ragged prompts in one lockstep batch: equal to JAX's ``generate_np``
    and to each row generated alone (rows joining mid-prompt are
    teacher-forced through their own prompt)."""
    _, jcfg, tcfg, jp, tp = family
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 97, (9,)).tolist(), rng.randint(1, 97, (4,)).tolist()]
    got = tgen.generate_np(tp, tcfg, prompts, max_new_tokens=5)
    assert got == jgen.generate_np(jp, jcfg, prompts, max_new_tokens=5)
    for p, row in zip(prompts, got):
        assert row == tgen.generate_np(tp, tcfg, [p], max_new_tokens=5)[0]
        assert row[: len(p)] == p
