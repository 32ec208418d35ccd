"""chip_smoke.py rehearsed on the CPU: its phases at toy size (the same
code the GPU run drives at ResNet-50 scale), and its refusal to report a
result from anything that is not a GPU."""

import json

import numpy as np
import pytest

import chip_smoke
from caffe_escoin_tpu.models import cifar


def test_main_refuses_a_cpu_device(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_main_four_refuses_a_cpu_device(capsys):
    assert chip_smoke.main(["--four"]) == 2
    assert capsys.readouterr().out == ""


def test_phase_forwards_toy():
    chip_smoke.phase_forwards(cifar.cifar10_bn, (2, 32, 32, 3), logits="ip1",
                              block=(16, 16))


def test_phase_spmm_toy():
    chip_smoke.phase_spmm(((40, 64, 32), (33, 32, 64)), block=(16, 16),
                          interpret=True)


def test_phase_autotune_toy():
    chip_smoke.phase_autotune((((2, 8, 8, 32), 3, 32, 32, 1, 1),),
                              block=(16, 16))


def test_phase_solver_toy():
    chip_smoke.phase_solver(cifar.cifar10_bn, (4, 32, 32, 3), 10, steps=2)


def test_checks_fail_loudly(capsys):
    checks = chip_smoke.Checks("demo")
    checks.bound("within", 1e-5, 1e-4)
    checks.bound("outside", 1e-2, 1e-4)
    with pytest.raises(AssertionError, match="outside"):
        checks.done()
    assert "FAIL" in capsys.readouterr().out


def test_rel_l2():
    a = np.ones(4)
    assert chip_smoke.rel_l2(a, a) == 0.0
    assert chip_smoke.rel_l2(a * 1.01, a) == pytest.approx(0.01)


def test_four_card_paths_on_virtual_devices():
    """The --four phase's checks on 4 virtual CPU devices at toy size."""
    import __graft_entry__ as graft

    errs = graft.multichip_checks(4, builder=cifar.cifar10_bn,
                                  input_shape=(8, 32, 32, 3), logits="ip1",
                                  block=(16, 16))
    assert set(errs) == set(graft.MULTICHIP_BOUNDS)
    for name, err in errs.items():
        assert err <= graft.MULTICHIP_BOUNDS[name], (name, err)
    json.dumps(errs)
