"""The one switch between compiled kernels (GPU) and interpret mode (CPU)."""

import pytest

from cloudsc2jax.device import cards_on_host, nvidia_smi, pallas_interpret


@pytest.mark.parametrize("platform,interpret", [("cpu", True), ("gpu", False)])
def test_pallas_interpret_by_platform(platform, interpret):
    assert pallas_interpret(platform) is interpret


def test_pallas_interpret_refuses_other_platforms():
    """A platform with no Pallas route is an error, not a guess."""
    with pytest.raises(RuntimeError, match="no Pallas route"):
        pallas_interpret("metal")


def test_pallas_interpret_reads_the_first_device():
    import jax

    assert jax.devices()[0].platform == "cpu"
    assert pallas_interpret() is True


def test_pallas_interpret_announces_on_cpu(capsys):
    assert pallas_interpret("cpu", announce=True)
    assert "Pallas interpret mode" in capsys.readouterr().err
    assert not pallas_interpret("gpu", announce=True)
    assert capsys.readouterr().err == ""


def test_nvidia_smi_absent_is_none(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert nvidia_smi() is None


def _fake_smi(tmp_path, ncards):
    """An nvidia-smi on PATH that lists ``ncards`` cards."""
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\n" + "".join(f"echo {i}\n" for i in range(ncards)))
    smi.chmod(0o755)
    return str(tmp_path)


@pytest.mark.parametrize("visible,n", [("0,1,2,3", 4), ("2", 1), ("", 0)])
def test_cards_on_host_follows_cuda_visible_devices(monkeypatch, tmp_path,
                                                    visible, n):
    monkeypatch.setenv("PATH", _fake_smi(tmp_path, 8))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert cards_on_host() == n


@pytest.mark.parametrize("ncards", [0, 4])
def test_cards_on_host_counts_nvidia_smi_cards(monkeypatch, tmp_path, ncards):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("PATH", _fake_smi(tmp_path, ncards) if ncards
                       else str(tmp_path))
    assert cards_on_host() == ncards
