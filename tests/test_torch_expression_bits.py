"""The evaluator's bits cases (tests/torch_builtin_cases.py):
casts (CAST to SIGNED/UNSIGNED/DOUBLE/DECIMAL/CHAR and the date
casts) and the bit operators over unsigned BIGINT bits at and above
2^63, shifts by -1, 63, 64 and more, BIT_COUNT.

Each case runs three ways on the CPU: the reference's numpy EvalCtx,
the reference's jnp EvalCtx under jax.jit (x64) where it traces, and
the port's EvalCtx over TorchNS("cpu") where the port's device rule
admits the shape (else its numpy host twin). All agree: ints, decimals,
unsigned bits and NULL masks exactly, float64 to rtol 1e-9, strings as
the text their codes decode to; the rule admits the shape exactly when
the reference's trace succeeds."""
import pytest

import torch_builtin_cases as T


@pytest.mark.parametrize("name", T.names("bits"))
def test_bits_three_ways(name):
    T.check_case(name)
