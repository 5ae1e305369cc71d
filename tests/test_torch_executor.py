"""The port's execution policies (zpc_tpu_torch.core.executor) against
zpc_tpu's (tests/test_executor.py's cases), on the CPU.

Floats are held at 1e-6 relative; a CUDA policy is tested only where a
card is present.
"""

import numpy as np
import pytest
import torch

# JAX is imported where it is installed (the machine with the card has
# none, and runs only the cuda test); every other test needs zpc_tpu
try:
    import jax.numpy as jnp
    import zpc_tpu as jz
except ImportError:
    jnp = jz = None

import zpc_tpu_torch as tz
from zpc_tpu_torch.core import executor as tex

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pols():
    return [tz.seq_exec(), tz.Executor(device=CPU), tz.Executor()]


def test_fluent_settings_are_value_semantic():
    a = tz.Executor(device=CPU)
    b = a.profile(True).sync(True)
    assert not a.profile_flag and b.profile_flag
    assert not a.sync_flag and b.sync_flag
    c = b.check(True)
    assert c.check_flag and not b.check_flag
    assert c.on("meta").device == torch.device("meta")
    assert c.device == CPU


def test_seq_is_the_cpu_oracle_policy():
    s = tz.seq_exec()
    assert s.is_sequential and s.check_flag and s.device == CPU
    assert not tz.Executor().is_sequential


def test_tpu_exec_is_the_cards_policy():
    """On a machine with a card it names it; without, it raises and never
    returns a CPU policy."""
    assert tz.jit_exec is tz.tpu_exec
    if torch.cuda.is_available():
        pol = tz.tpu_exec()
        assert pol.device.type == "cuda" and not pol.is_sequential
    else:
        with pytest.raises(RuntimeError):
            tz.tpu_exec()
        with pytest.raises(RuntimeError):
            tz.cuda_device()


@pytest.mark.parametrize("k", range(3))
def test_run_agrees_with_zpc_tpu(k):
    x = np.random.default_rng(k).standard_normal(128).astype(np.float32)
    ref = float(jz.tpu_exec().run(lambda a: jnp.sum(a * a), jnp.asarray(x)))
    got = _pols()[k].run(lambda a: torch.sum(a * a), torch.from_numpy(x))
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)


def test_foreach_and_map():
    pol = tz.Executor(device=CPU)
    out = pol.foreach(lambda i: i * i, 10)
    ref = np.asarray(jz.tpu_exec().foreach(lambda i: i * i, 10))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    x = np.random.default_rng(1).standard_normal((64, 3)).astype(np.float32)
    got = pol.map(lambda v: torch.sum(v * v), torch.from_numpy(x))
    ref = np.asarray(jz.tpu_exec().map(lambda v: jnp.sum(v * v),
                                       jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    # foreach passes its extra arguments through
    got = pol.foreach(lambda i, s: i + s, 4, torch.tensor(3))
    np.testing.assert_array_equal(got.numpy(), [3, 4, 5, 6])
    # a policy that names no device follows its arguments
    got = tz.Executor().foreach(lambda i, s: i + s, 4, torch.tensor(3))
    assert got.device == CPU
    np.testing.assert_array_equal(got.numpy(), [3, 4, 5, 6])


def test_foreach_without_a_device_takes_the_card(monkeypatch):
    """With no device named by the policy or an argument, the index goes
    to the card; where there is none that raises, and never lands on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tz.Executor().foreach(lambda i: i * i, 10)


def test_check_catches_out_of_bounds():
    pol = tz.Executor(device=CPU).check(True)
    with pytest.raises(IndexError):
        pol.run(lambda a: a[torch.tensor(100)], torch.arange(8.0))


def test_check_catches_nan():
    pol = tz.Executor(device=CPU).check(True)
    with pytest.raises(FloatingPointError):
        pol.run(lambda a: torch.log(a - 10.0), torch.arange(4.0))
    # nested outputs are checked too; without check the NaN passes
    with pytest.raises(FloatingPointError):
        pol.run(lambda a: (a, {"y": a / 0.0 * 0.0}), torch.ones(2))
    out = tz.Executor(device=CPU).run(lambda a: torch.log(a - 10.0),
                                      torch.arange(4.0))
    assert torch.isnan(out).all()


def test_profile_prints(capsys):
    pol = tz.Executor(device=CPU).profile(True)
    out = pol.run(lambda x: x + 1, torch.zeros(4), label="probe")
    assert torch.equal(out, torch.ones(4))
    line = capsys.readouterr().out
    assert line.startswith("[zpc_tpu_torch exec | test_torch_executor.py:")
    assert "probe" in line and line.rstrip().endswith("ms")


def test_scope_timer(capsys):
    with tz.Executor(device=CPU).profile(True).scope("region"):
        pass
    out = capsys.readouterr().out
    assert "region" in out and "test_torch_executor.py:" in out
    with tz.Executor(device=CPU).scope("quiet"):
        pass
    assert capsys.readouterr().out == ""


def test_compile_accepts_donation():
    """``donate_argnums`` has no meaning in PyTorch: accepted, and the
    input is left as it was."""
    pol = tz.Executor(device=CPU)
    f = pol.compile(lambda a: a * 2, donate_argnums=(0,))
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal(8).astype(np.float32))
    keep = x.clone()
    np.testing.assert_allclose(f(x).numpy(), keep.numpy() * 2, rtol=1e-6)
    assert torch.equal(x, keep)


def test_policy_refuses_other_devices():
    pol = tz.Executor(device=CPU)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        pol.run(lambda a: a + 1, meta)
    with pytest.raises(ValueError):
        pol.run(lambda a, b: a + b, torch.zeros(4), b=meta)
    with pytest.raises(ValueError):
        tz.Executor(device=torch.device("meta")).run(lambda a: a,
                                                     torch.zeros(1))
    # a policy with no device follows its tensors
    assert tz.Executor().run(lambda a: a + 1, meta).device.type == "meta"


def test_par_exec_and_sync():
    pol = tz.Executor(device=CPU).sync(True)
    a, b = tex.par_exec((pol, lambda x: x + 1, torch.ones(2)),
                        (tz.seq_exec(), lambda x: x * 3, torch.ones(2)))
    assert a.tolist() == [2.0, 2.0] and b.tolist() == [3.0, 3.0]
    ref = jz.core.executor.par_exec(
        (jz.tpu_exec(), lambda x: x + 1, jnp.ones(2)))
    np.testing.assert_array_equal(np.asarray(ref[0]), a.numpy())


@pytest.mark.cuda
def test_cuda_policy_profiles_with_events(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pol = tz.tpu_exec().profile(True).sync(True)
    x = torch.ones(1 << 20, device=pol.device)
    out = pol.run(lambda a: a * 2, x, label="twice")
    assert float(out.sum()) == 2 * (1 << 20)
    assert "twice" in capsys.readouterr().out
    with pytest.raises(ValueError):
        pol.run(lambda a: a, torch.ones(2))
