"""The evaluator's dates cases (tests/torch_builtin_cases.py):
dates and times (QUARTER ... TIMESTAMPDIFF, TIMESTAMPADD, over
DATE, DATETIME, dates as dictionary text and constants; leap days and
year boundaries).

Each case runs three ways on the CPU: the reference's numpy EvalCtx,
the reference's jnp EvalCtx under jax.jit (x64) where it traces, and
the port's EvalCtx over TorchNS("cpu") where the port's device rule
admits the shape (else its numpy host twin). All agree: ints, decimals,
unsigned bits and NULL masks exactly, float64 to rtol 1e-9, strings as
the text their codes decode to; the rule admits the shape exactly when
the reference's trace succeeds."""
import pytest

import torch_builtin_cases as T


@pytest.mark.parametrize("name", T.names("dates"))
def test_dates_three_ways(name):
    T.check_case(name)
