"""``repro_torch.eval`` — the seeded reasoning eval harness (the port's
``repro.eval``; docs/EVAL.md).

Trains tiny-lm on deterministic synthetic reasoning traces (associative
recall, running-sum arithmetic chains, copy chains — every example has a
checkable final answer), serves the eval set across compression budgets
(``n_max`` × window, against the Full-KV baseline) through the port's
facade, and emits the ``zipage-eval/v1`` JSON. On the card its serves run
the hand-written decode, scoring, redundancy and compaction kernels.

Run it:

    python -m repro_torch.eval --smoke --out eval-smoke.json
"""
from repro_torch.eval.tasks import TASK_KINDS, make_example, train_batch  # noqa
from repro_torch.eval.runner import (  # noqa: F401
    EVAL_SCHEMA, run_eval, token_agreement, trained_params)
