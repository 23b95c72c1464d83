"""PyTorch port: the reference checkpoint importer
(``tools/import_torch.py``, ``cli import-torch``) against the JAX
package's importer.

The ``.pth`` inputs are written with ``torch.save`` from known tensors in
each schema the reference's loader understands: the legacy flat QNet, the
dueling NoisyNet QNet and the QNetRNN (1 and 2 LSTM layers, with and
without the shared head), wrapped (``modelB``, ``modelB_state``, ...)
and bare, with scalars. For each, the port's output checkpoint must equal
the JAX importer's array for array (values and dtypes) and in
``meta.json``, and load in both packages; the migrated legacy net must
compute the torch ``fc`` forward's Q-values. The port loads the
importers' Fortran-order arrays as row-major parameters.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.checkpoint.serialize import params_from_dict as jfrom_dict
from pingpong_tpu.checkpoint.store import load_checkpoint as jload_ckpt
from pingpong_tpu.models.qnet import qnet_apply as jqnet_apply
from pingpong_tpu.tools import import_torch as jimp
from pingpong_tpu_torch import cli
from pingpong_tpu_torch.models.qnet import qnet_apply
from pingpong_tpu_torch.models.qnet_rnn import (
    QNetRNN,
    init_hidden,
    qnet_rnn_apply,
)
from pingpong_tpu_torch.selfplay.pool import load_params_any
from pingpong_tpu_torch.tools import import_torch as imp


def randn(g, *shape, scale=0.2):
    return torch.randn(*shape, generator=g) * scale


def legacy_sd(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "fc.0.weight": randn(g, 64, 7, scale=1.0),
        "fc.0.bias": randn(g, 64, scale=1.0),
        "fc.2.weight": randn(g, 64, 64, scale=0.1),
        "fc.2.bias": randn(g, 64, scale=1.0),
        "fc.4.weight": randn(g, 3, 64, scale=0.1),
        "fc.4.bias": randn(g, 3, scale=1.0),
    }


def noisy(g, prefix, n_out, n_in):
    return {
        f"{prefix}.weight_mu": randn(g, n_out, n_in),
        f"{prefix}.weight_sigma": torch.full((n_out, n_in), 0.017),
        f"{prefix}.bias_mu": randn(g, n_out, scale=0.1),
        f"{prefix}.bias_sigma": torch.full((n_out,), 0.017),
        # the reference's noise buffers; the importer drops them
        f"{prefix}.weight_epsilon": randn(g, n_out, n_in),
        f"{prefix}.bias_epsilon": randn(g, n_out),
    }


def dueling_sd(seed=1):
    g = torch.Generator().manual_seed(seed)
    return {
        "features.0.weight": randn(g, 64, 7), "features.0.bias": randn(g, 64),
        "features.2.weight": randn(g, 64, 64),
        "features.2.bias": randn(g, 64),
        **noisy(g, "fc_V", 1, 64), **noisy(g, "fc_A", 3, 64),
    }


def rnn_sd(layers=1, shared=True, seed=2, F=32, H=16, S=24):
    g = torch.Generator().manual_seed(seed)
    sd = {
        "features_extractor.0.weight": randn(g, F // 2, 7),
        "features_extractor.0.bias": randn(g, F // 2),
        "features_extractor.2.weight": randn(g, F, F // 2),
        "features_extractor.2.bias": randn(g, F),
    }
    for l in range(layers):
        sd.update({
            f"lstm.weight_ih_l{l}": randn(g, 4 * H, F if l == 0 else H),
            f"lstm.weight_hh_l{l}": randn(g, 4 * H, H),
            f"lstm.bias_ih_l{l}": randn(g, 4 * H),
            f"lstm.bias_hh_l{l}": randn(g, 4 * H),
        })
    head_in = S if shared else H
    if shared:
        sd.update(noisy(g, "fc_shared_head.0", S, H))
    sd.update(noisy(g, "fc_V", 1, head_in))
    sd.update(noisy(g, "fc_A", 3, head_in))
    return sd


CASES = {
    "legacy_modelB_modelA_scalars": lambda: {
        "modelB": legacy_sd(3), "modelA": legacy_sd(4), "epsilon": 0.25,
        "episode": 77, "generation": 5, "train_steps_count": 1234},
    "legacy_bare": lambda: legacy_sd(5),
    "dueling_modelB_state": lambda: {"modelB_state": dueling_sd(),
                                     "optimizer": {"lr": 1e-4}},
    "dueling_model": lambda: {"model": dueling_sd(6), "episode": 3},
    "rnn_1layer_shared_state_dict": lambda: {"state_dict": rnn_sd()},
    "rnn_2layer_shared_modelA_state": lambda: {
        "modelA_state": rnn_sd(2, seed=7), "modelB_state": rnn_sd(2, seed=8),
        "train_steps_count": 99},
    "rnn_1layer_no_shared_bare": lambda: rnn_sd(1, False, seed=9),
    "rnn_2layer_no_shared_bare": lambda: rnn_sd(2, False, seed=10),
}


def read_checkpoint(path):
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads((path / "meta.json").read_text())


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_checkpoint_equals_jax_importers(tmp_path, case):
    src = tmp_path / f"{case}.pth"
    torch.save(CASES[case](), src)
    mine = imp.import_torch_checkpoint(str(src), str(tmp_path / "port"))
    theirs = jimp.import_torch_checkpoint(str(src), str(tmp_path / "jax"))
    (a_mine, m_mine), (a_theirs, m_theirs) = (read_checkpoint(mine),
                                              read_checkpoint(theirs))
    assert m_mine == m_theirs
    assert sorted(a_mine) == sorted(a_theirs)
    for k in a_mine:
        assert a_mine[k].dtype == a_theirs[k].dtype, k
        np.testing.assert_array_equal(a_mine[k], a_theirs[k], err_msg=k)
    # the result loads in both packages, as the kind the .pth holds
    params = load_params_any(mine)
    payload = jload_ckpt(mine)
    jparams = jfrom_dict(payload.get("params_b") or payload["params_a"])
    assert isinstance(params, QNetRNN) == ("rnn" in case)
    assert (type(jparams).__name__ == "QNetRNNParams") == ("rnn" in case)
    # the importers write transposed (Fortran-order) weights; the port
    # loads every parameter row-major, so a forward on the card sums in
    # the same order as for the same weights trained by the port
    assert any(a.flags.f_contiguous and not a.flags.c_contiguous
               for a in a_mine.values())
    assert all(p.is_contiguous() for p in params.parameters())


def torch_legacy_forward(sd, x):
    lin = torch.nn.functional.linear
    h = torch.relu(lin(x, sd["fc.0.weight"], sd["fc.0.bias"]))
    h = torch.relu(lin(h, sd["fc.2.weight"], sd["fc.2.bias"]))
    return lin(h, sd["fc.4.weight"], sd["fc.4.bias"])


def test_legacy_q_values_equal_the_fc_forward(tmp_path):
    sd = legacy_sd()
    torch.save({"modelB": sd}, tmp_path / "m.pth")
    out = imp.import_torch_checkpoint(str(tmp_path / "m.pth"),
                                      str(tmp_path / "m"))
    x = np.random.default_rng(0).normal(size=(16, 7)).astype(np.float32)
    want = torch_legacy_forward(sd, torch.from_numpy(x)).numpy()
    # Q = V + (A - mean A) with V = the row-mean of fc.4 collapses to fc4(x)
    got = qnet_apply(load_params_any(out), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jgot = np.asarray(jqnet_apply(jfrom_dict(jload_ckpt(out)["params_b"]),
                                  jnp.asarray(x)))
    np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-6)
    # fresh sigmas at SIGMA_INIT
    assert float(load_params_any(out).fc_a.w_sigma.min()) == np.float32(
        imp.SIGMA_INIT)


def test_rnn_import_equals_torch_lstm_forward(tmp_path):
    sd = rnn_sd(2, True)
    torch.save(sd, tmp_path / "r.pth")
    params = load_params_any(imp.import_torch_checkpoint(
        str(tmp_path / "r.pth"), str(tmp_path / "r")))
    assert len(params.lstm) == 2 and params.dims == (16, 32, 16, 24)
    B, T = 3, 5
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, T, 7)).astype(np.float32))
    lin = torch.nn.functional.linear
    f = torch.relu(lin(x, sd["features_extractor.0.weight"],
                       sd["features_extractor.0.bias"]))
    f = torch.relu(lin(f, sd["features_extractor.2.weight"],
                       sd["features_extractor.2.bias"]))
    lstm = torch.nn.LSTM(32, 16, 2, batch_first=True)
    with torch.no_grad():
        for name, p in lstm.named_parameters():
            p.copy_(sd[f"lstm.{name}"])
        out, _ = lstm(f)
    h = torch.relu(lin(out[:, -1], sd["fc_shared_head.0.weight_mu"],
                       sd["fc_shared_head.0.bias_mu"]))
    v = lin(h, sd["fc_V.weight_mu"], sd["fc_V.bias_mu"])
    a = lin(h, sd["fc_A.weight_mu"], sd["fc_A.bias_mu"])
    want = (v + a - a.mean(dim=1, keepdim=True)).detach().numpy()
    q, _ = qnet_rnn_apply(params, x, init_hidden(params, (B,)))
    np.testing.assert_allclose(q.numpy(), want, rtol=1e-4, atol=1e-5)


def test_import_dir_and_cli(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    torch.save({"modelB": dueling_sd()}, src / "a.pth")
    torch.save(rnn_sd(), src / "b.pth")
    torch.save({"nothing": 1}, src / "c.pth")
    assert cli.main(["import-torch", str(src), str(tmp_path / "out")]) == 0
    out = capsys.readouterr().out
    assert "imported 2/3 checkpoints" in out and "skip c.pth" in out
    assert isinstance(load_params_any(tmp_path / "out" / "b"), QNetRNN)
    assert cli.main(["import-torch", str(src / "a.pth"),
                     str(tmp_path / "one")]) == 0
    load_params_any(tmp_path / "one")
    rc = cli.main(["import-torch", str(tmp_path / "missing.pth"),
                   str(tmp_path / "x")])
    assert rc == 2
    assert "error: file not found" in capsys.readouterr().err
