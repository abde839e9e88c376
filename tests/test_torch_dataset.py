"""The PyTorch port's site-specific Dataset channel (`channel/dataset.py`,
`channel/io_native.py`, `sim/trajectory.py` and their wiring) against the
JAX package.

- The port's generator writes the repository's `data/*.cirbin` byte for
  byte (eval: 200 points, seed 1; train: 2000 points, seed 0; md5 pinned)
  into a temporary directory, and JAX's files at other arguments; its
  native reader equals its NumPy reader and JAX's NumPy reader; a
  `.tfrecord` name falls back to `.cirbin`, then `.npz`.
- Partitions, `max_num_examples` and the records as JAX's `DatasetChannel`;
  `cfr` fed the record indices JAX's `randint` draws from the same key
  within 1e-5 of max |h| of JAX's `DatasetChannel.__call__`, at 48 and
  1584 subcarriers, in training (random subsampling per user) and eval
  (paired starts) modes.
- nrx_site_specific_100k's eval E2E model at 4 PRB (JAX's eval grid cut
  from 132) and nrx_site_specific's training forward at its training width
  (4 PRB), fed JAX's draws of its key schedule (the Dataset channel's CFRs
  included), with JAX's seed-made parameters: the eval forward's refined
  channel estimate, its LS estimate and the true channel within 1e-5 of
  JAX's eval call's, b and the CRC equal; the training losses within 1e-5.
- Covariances draw on the Dataset channel; `refuse_unported` accepts it;
  a mesh that is not a `dist.mesh.Mesh` is refused; the configurations'
  dataset wiring
  (`data_dir`, an absolute `tfrecord_filename`, `cir_max_records`).
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_rx_tpu.channel.dataset import DatasetChannel as JaxChannel
from neural_rx_tpu.channel.io_native import _read_cirbin_np as jax_read_np
from neural_rx_tpu.phy.misc import binary_source as jax_binary_source
from neural_rx_tpu.phy.misc import complex_awgn as jax_complex_awgn
from neural_rx_tpu.sim.config import Parameters as JaxParameters
from neural_rx_tpu.sim.e2e import E2EModel as JaxE2EModel
from neural_rx_tpu.sim.trajectory import \
    generate_synthetic_cir_dataset as jax_generate
from neural_rx_tpu_torch import weights
from neural_rx_tpu_torch.channel import io_native
from neural_rx_tpu_torch.channel.dataset import (DatasetChannel,
                                                 load_cir_records)
from neural_rx_tpu_torch.sim import covariance, trajectory
from neural_rx_tpu_torch.sim.config import CONFIG_DIR, Parameters
from neural_rx_tpu_torch.sim.e2e import E2EModel

MD5 = {trajectory.TRAIN_FILE: "e544e3a74fdbe8c6b1b8524ae3c34b36",
       trajectory.EVAL_FILE: "74d4594bc73ca5afedea1ecb091a110e"}
BAR = 1e-5
BATCH = 2
SCS = 30e3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch in one thread: the suite runs one worker per core or so."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("site"))
    trajectory.write_committed_site_datasets(d)
    return d


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def test_generator_writes_the_committed_files(data_dir):
    for name, md5 in MD5.items():
        assert _md5(os.path.join(data_dir, name)) == md5, name


def test_generator_equals_jax_at_other_arguments(tmp_path):
    args = ([[0, 0, 1.5], [30, 10, 1.5]], 17, [5.0, 3.0, 20.0])
    kw = {"num_paths": 6, "num_rx_ant": 2, "num_tx_ant": 1, "seed": 5}
    pos = trajectory.generate_synthetic_cir_dataset(
        str(tmp_path / "port.cirbin"), *args, **kw)
    jpos = jax_generate(str(tmp_path / "jax.cirbin"), *args, **kw)
    np.testing.assert_array_equal(pos, jpos)
    with open(tmp_path / "port.cirbin", "rb") as a, \
            open(tmp_path / "jax.cirbin", "rb") as b:
        assert a.read() == b.read()


def test_ensure_site_datasets_writes_only_what_is_missing(tmp_path):
    d = str(tmp_path)
    train, ev = trajectory.ensure_site_datasets(d, num_points=10)
    assert io_native.read_cirbin(ev)[0].shape == (10, 4, 2, 12)
    before = _md5(train)
    assert trajectory.ensure_site_datasets(d) == (train, ev)
    assert _md5(train) == before


def test_native_reader_equals_numpy_and_jax(data_dir):
    for name in MD5:
        path = os.path.join(data_dir, name)
        a, tau = io_native.read_cirbin(path)
        for a2, tau2 in (io_native.read_cirbin_numpy(path),
                         jax_read_np(path)):
            np.testing.assert_array_equal(a, a2)
            np.testing.assert_array_equal(tau, tau2)
        assert a.dtype == np.complex64 and tau.dtype == np.float32
    assert a.shape == (200, 4, 2, 12) and tau.shape == (200, 12)
    assert os.path.basename(io_native.library_path()).startswith(
        "libcirreader_")


def test_tfrecord_name_falls_back(tmp_path, data_dir):
    a, tau = io_native.read_cirbin(os.path.join(data_dir,
                                                trajectory.EVAL_FILE))
    io_native.write_cirbin(str(tmp_path / "x.cirbin"), a, tau)
    for got, want in zip(load_cir_records(str(tmp_path / "x.tfrecord")),
                         (a, tau)):
        np.testing.assert_array_equal(got, want)
    np.savez(tmp_path / "y.npz", a=a[:5], tau=tau[:5])
    got = load_cir_records(str(tmp_path / "y.tfrecord"))
    np.testing.assert_array_equal(got[0], a[:5])
    with pytest.raises(FileNotFoundError, match="trajectory"):
        load_cir_records(str(tmp_path / "z.tfrecord"))
    with pytest.raises(ValueError, match="CIR1"):
        (tmp_path / "bad.cirbin").write_bytes(b"NOPE" + bytes(16))
        io_native.read_cirbin_numpy(str(tmp_path / "bad.cirbin"))


@pytest.mark.parametrize("training,subsampling,max_ex", [
    (True, True, -1), (False, True, 31), (True, False, 0)])
def test_partitions_as_jax(data_dir, training, subsampling, max_ex):
    path = os.path.join(data_dir, trajectory.TRAIN_FILE)
    ch = DatasetChannel(path, training, 2, subsampling,
                        max_num_examples=max_ex)
    jch = JaxChannel(path, training, 2, subsampling,
                     max_num_examples=max_ex)
    assert ch.pair_offset == jch.pair_offset
    assert len(ch.partitions) == 2
    for p, jp in zip(ch.partitions, jch.partitions):
        np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(ch.a, jch.a)
    np.testing.assert_array_equal(ch.tau, jch.tau)


def _jax_indices(key, batch, num_tx, part, per_user):
    """The record indices JAX's DatasetChannel.__call__ draws from key."""
    if per_user:
        idx = jax.random.randint(key, (batch, num_tx), 0, part)
    else:
        idx = jax.random.randint(key, (batch, 1), 0, part)
    return np.asarray(idx + jnp.arange(num_tx)[None, :] * part)


@pytest.mark.parametrize("num_sc", [48, 1584])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_cfr_matches_jax(data_dir, num_sc, training):
    path = os.path.join(data_dir, trajectory.EVAL_FILE)
    key = jax.random.PRNGKey(11)
    jch = JaxChannel(path, training, 2, random_subsampling=True)
    want = np.asarray(jch(key, 4, 2, 14, num_sc, SCS))
    ch = DatasetChannel(path, training, 2, random_subsampling=True)
    idx = _jax_indices(key, 4, 2, ch.pair_offset, per_user=training)
    got = ch.cfr(torch.as_tensor(idx), 14, num_sc, SCS)
    assert got.shape == want.shape == (4, 4, 2, 2, 14, num_sc)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) <= BAR


def test_draw_indices_lie_in_the_partitions(data_dir):
    path = os.path.join(data_dir, trajectory.TRAIN_FILE)
    gen = torch.Generator().manual_seed(0)
    train = DatasetChannel(path, True, 2, random_subsampling=True)
    idx = train.draw(gen, 256, 2)
    assert idx.shape == (256, 2) and idx.dtype == torch.int64
    assert bool((idx // train.pair_offset == torch.arange(2)).all())
    assert bool((idx[:, 1] - idx[:, 0] != train.pair_offset).any())
    paired = DatasetChannel(path, False, 2, random_subsampling=True)
    idx = paired.draw(gen, 64, 2)
    assert bool((idx[:, 1] - idx[:, 0] == paired.pair_offset).all())
    assert int(idx.max()) < 2 * paired.pair_offset


def _cut_config(tmp_path, label, width):
    text = open(os.path.join(CONFIG_DIR, label + ".cfg")).read()
    text = text.replace("n_size_bwp_eval = 132\n",
                        f"n_size_bwp_eval = {width}\n")
    (tmp_path / (label + ".cfg")).write_text(text)
    return str(tmp_path)


def _jax_draws(jm, key, batch, ebno, training):
    """Bits, slot, CFRs and noise of JAX's E2EModel.__call__ from key."""
    p = jm.p
    keys = jax.random.split(key, 8)
    bits = [jax_binary_source(jax.random.fold_in(keys[1], i),
                              (batch, p.max_num_tx, tx.tb_size))
            for i, tx in enumerate(jm.transmitters)]
    slot = jax.random.randint(keys[2], (), 0, jm._num_slots)
    rg = jm.transmitters[0].resource_grid
    nsym, nsc = rg.num_ofdm_symbols, rg.num_subcarriers
    kc, kn = jax.random.split(keys[4])
    h = p.channel_model(kc, batch, p.max_num_tx, nsym, nsc,
                        p.carrier.subcarrier_spacing)
    no = jm._noise_variance(ebno, 0)
    if training:
        no = no.reshape(batch, 1, 1, 1)
    noise = jax_complex_awgn(kn, (batch, p.num_rx_antennas, nsym, nsc), no)
    return [np.asarray(b) for b in bits], int(slot), np.asarray(h), \
        np.asarray(noise)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return torch.tensor(np.asarray(tree))


def test_eval_forward_matches_jax(tmp_path, data_dir):
    """nrx_site_specific_100k, eval grid cut to 4 PRB, its eval trajectory,
    JAX's seed-made parameters, 8 dB, the flooding decoder."""
    cfg_dir = _cut_config(tmp_path, "nrx_site_specific_100k", 4)
    eval_path = os.path.join(data_dir, trajectory.EVAL_FILE)
    jp = JaxParameters("nrx_site_specific_100k", system="nrx",
                       training=False, config_dir=cfg_dir,
                       overrides={"tfrecord_filename": eval_path})
    jm = JaxE2EModel(jp, training=False)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda prm, k: jm(prm, k, BATCH, 8.0,
                                     output_nrx_h_hat=True))(jparams, key)
    p = Parameters("nrx_site_specific_100k", training=False,
                   config_dir=cfg_dir, data_dir=data_dir)
    assert p.channel_model.training is False and p.max_num_tx == 2
    bits, _, h, noise = _jax_draws(jm, key, BATCH, 8.0, training=False)
    got = E2EModel(p, device="cpu").forward(
        {"cgnn": weights.from_jax_numpy(jax.tree.map(
            np.asarray, jparams["cgnn"]))}, _to_torch(bits),
        torch.as_tensor(h), torch.as_tensor(noise), output_nrx_h_hat=True)
    b, _, crc, h_true, h_ref, h_init = got
    jb, _, jcrc, jh_true, jh_ref, jh_init = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(b.numpy(), jb)
    np.testing.assert_array_equal(crc.numpy(), jcrc)
    for g, w in ((h_true, jh_true), (h_ref, jh_ref), (h_init, jh_init)):
        assert g.shape == w.shape and _rel(g.numpy(), w) <= BAR


def test_training_forward_matches_jax(data_dir):
    """nrx_site_specific at its training width (4 PRB, paired draws on the
    train trajectory), users (1, 1) and (1, 0), Eb/N0 per item."""
    train_path = os.path.join(data_dir, trajectory.TRAIN_FILE)
    jp = JaxParameters("nrx_site_specific", system="nrx", training=True,
                       overrides={"tfrecord_filename": train_path})
    jm = JaxE2EModel(jp, training=True)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(9)
    ebno = jnp.asarray([4.0, 9.0], jnp.float32)
    active = np.asarray([[1, 1], [1, 0]], np.float32)
    mask = np.ones((BATCH, 2, 1), np.float32)
    ld, lc = jax.jit(lambda prm: jm(
        prm, key, BATCH, ebno, num_tx=2, active_dmrs=jnp.asarray(active),
        mcs_ue_mask=jnp.asarray(mask)))(jparams)
    p = Parameters("nrx_site_specific", training=True, data_dir=data_dir)
    assert p.channel_model.random_subsampling is False
    bits, slot, h, noise = _jax_draws(jm, key, BATCH, ebno, training=True)
    model = E2EModel(p, training=True, device="cpu")
    got = model.forward(
        {"cgnn": weights.from_jax_numpy(jax.tree.map(
            np.asarray, jparams["cgnn"]))}, _to_torch(bits),
        torch.as_tensor(h), torch.as_tensor(noise),
        active_dmrs=torch.as_tensor(active),
        mcs_ue_mask=torch.as_tensor(mask), slot_idx=slot)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(ld), float(lc)], rtol=BAR, atol=0)


def test_covariance_draw_on_the_dataset(data_dir):
    p = Parameters("nrx_site_specific_baseline",
                   system="baseline_lslin_lmmse", training=False,
                   data_dir=data_dir)
    h = covariance.draw(p, torch.Generator().manual_seed(0), 3)
    assert h.shape == (3, 4, 4, 14, 1584) and bool(torch.isfinite(h).all())
    cf, ct, cs = covariance.accumulate(h)
    for c in (cf, ct, cs):
        assert torch.allclose(c, c.conj().T, atol=1e-5)
        assert float(torch.diagonal(c).real.mean()) == pytest.approx(
            1.0, rel=1e-4)


def test_dataset_channel_wiring(tmp_path, data_dir):
    p = Parameters("nrx_site_specific_100k", training=False,
                   data_dir=data_dir)
    assert isinstance(p.channel_model, DatasetChannel)
    assert p.channel_model.a.shape[0] == 200  # the eval trajectory
    E2EModel(p, device="cpu")  # the Dataset channel is no longer refused
    with pytest.raises(TypeError, match="multi-GPU"):  # not a mesh
        E2EModel(p, mesh=object(), device="cpu")
    p = Parameters("nrx_site_specific", training=True, data_dir=data_dir,
                   overrides={"cir_max_records": 100})
    assert p.channel_model.a.shape[0] == 100
    assert p.channel_model.pair_offset == 50
    absolute = os.path.join(data_dir, trajectory.EVAL_FILE)
    p = Parameters("nrx_site_specific", training=True,
                   data_dir=str(tmp_path),
                   overrides={"tfrecord_filename": absolute})
    assert p.channel_model.a.shape[0] == 200
    with pytest.raises(FileNotFoundError):
        Parameters("nrx_site_specific", training=True,
                   data_dir=str(tmp_path))
