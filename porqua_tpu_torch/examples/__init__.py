"""Runnable examples of the port: the twins of the JAX package's
``examples/*.py`` (the reference's notebooks as scripts, and three
tuning demonstrations beyond it), one module per script under the same
name. Each has ``main(device=None, ...)``: the card unless the caller
names another device, printing what the JAX example prints and
returning those numbers as a dict. Run one with

    python -m porqua_tpu_torch.examples.<name> [--device cpu]

or all of them with ``python -m porqua_tpu_torch.examples``. Nothing
runs at import.
"""

EXAMPLES = (
    "quickstart",
    "index_replication",
    "backtest_usa",
    "compare_solver",
    "cost_aware_backtest",
    "differentiable_tuning",
    "cost_penalty_tuning",
    "net_sharpe_tuning",
    "ordinal_regression",
    "lstm_selection",
    "ml_prediction",
)
