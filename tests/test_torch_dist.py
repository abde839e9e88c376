"""The port's multi-GPU layer (`neural_rx_tpu_torch/dist/`) on the CPU: one
gloo group of 2 ranks and one of 4, each started once (`dist.launch`,
`spawn`, a `file://` rendezvous) and running every case
(`dist.checks.run_jobs`), against single-process runs and the JAX package.

The ranks import the port alone; the JAX side runs here, in the test
process. Inputs come from numpy seeds. Cases, in each group:

1. the stack on subcarrier shards (the plain version of the stack kernel,
   halos exchanged) against the unsharded port and against JAX's
   `fused_conv_stack_sharded` under `shard_map` on the 8-device virtual CPU
   mesh in interpret mode, within 2e-5 (as tests/test_sepconv_pallas.py);
2. the CGNN iteration on shards (state and readout mode) against the
   unsharded iteration, within 2e-5;
3. `cgnn_apply` on meshes data x grid (2: 1 x 2 and 2 x 1; 4: 2 x 2 and
   1 x 4) with tests/test_sharding.py's small configuration and JAX's
   init, against JAX's unsharded output within 2e-4 (as that file);
4. `sim_ber` on a data 2 x grid (world / 2) mesh (mode a) against the
   single-process `sim_ber`: counters equal (as tests/test_simber_mesh.py,
   on test_small with the committed nrx_rt weights);
5. `sim_ber` without a mesh on several processes (mode b) against an
   in-process replay of every rank's `host_generator` stream through the
   same accumulate-and-stop loop, as tests/test_multiprocess_simber.py:
   counters equal, the stop decided on global counts;
6. one training step on a data x 1 mesh: the parameters equal on every
   rank, within 1e-6 of the single-process step on the global batch;
7. `make_mesh`'s default factorisation equals JAX's `mesh.shape`.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functools import partial
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from neural_rx_tpu.dist.fused_sharded import (
    fused_conv_stack_sharded as jax_stack_sharded)
from neural_rx_tpu.dist.mesh import make_mesh as jax_make_mesh
from neural_rx_tpu.rx.cgnn import CGNNConfig as JaxCGNNConfig
from neural_rx_tpu.rx.cgnn import cgnn_apply as jax_cgnn_apply
from neural_rx_tpu.rx.cgnn import init_cgnn_params as jax_init_cgnn
from neural_rx_tpu_torch import weights
from neural_rx_tpu_torch.dist import checks, mesh as port_mesh, multihost
from neural_rx_tpu_torch.dist.launch import run_ranks
from neural_rx_tpu_torch.kernels.cgnn_iter import fused_iteration_reference
from neural_rx_tpu_torch.kernels.sepconv import sepconv_stack_reference
from neural_rx_tpu_torch.rx.cgnn import CGNNConfig
from neural_rx_tpu_torch.sim.config import Parameters
from neural_rx_tpu_torch.sim.e2e import E2EModel
from neural_rx_tpu_torch.sim.simber import make_eval_step, sim_ber

WORLDS = (2, 4)
CFG_DIR = os.path.join(os.path.dirname(__file__), "data")
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
# sim_ber as tests/test_simber_mesh.py: test_small, batch 8, 2 steps, 4 dB
MESH_SIMBER = dict(ebno_dbs=[4.0], batch_size=8, max_mc_iter=2,
                   num_target_block_errors=10**9, seed=7)
# mode b: 4 x 2 blocks a rank and step; at -2 dB every block fails, so 20
# block errors stop the point after 2 steps on 2 ranks (1 on 4), where one
# rank alone would need 3
HOST_SIMBER = dict(ebno_dbs=[-2.0], batch_size=4, max_mc_iter=3,
                   num_target_block_errors=20, seed=11)
TRAIN_BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32))


def small_cfg(port: bool, layer_type_conv: str = "sepconv"):
    """tests/test_sharding.py's configuration (or with full 3x3 conv
    layers)."""
    return (CGNNConfig if port else JaxCGNNConfig)(
        num_bits_per_symbol=(4,), num_rx_ant=4, num_it=2, d_s=16,
        num_units_init=(32,), num_units_agg=((16,), (16,)),
        num_units_state=((32,), (32,)), num_units_readout=(32,),
        initial_chest=True, layer_type_conv=layer_type_conv)


def glorot_stack(rng, c_in, hidden, c_out):
    """A separable stack of numpy arrays in the JAX layout, nonzero
    biases."""
    layers, c = [], c_in
    for o in list(hidden) + [c_out]:
        layers.append({"dw": rng.normal(0, 0.3, (3, 3, 1, c)),
                       "pw": rng.normal(0, (2 / (c + o)) ** 0.5, (c, o)),
                       "b": rng.normal(0, 0.1, (o,))})
        c = o
    layers = [{k: v.astype(np.float32) for k, v in lay.items()}
              for lay in layers]
    return {"hidden": layers[:-1], "out": layers[-1]}


class Inputs:
    """Every case's inputs, from numpy seeds and JAX's init."""

    def __init__(self):
        rng = np.random.default_rng(0)
        self.stack_np = glorot_stack(rng, 12, [16, 16], 8)
        self.stack = to_torch(self.stack_np)
        self.x = rng.normal(size=(2, 14, 96, 12)).astype(np.float32)
        self.cgnn_j = jax.jit(jax_init_cgnn, static_argnums=1)(
            jax.random.PRNGKey(0), small_cfg(False))
        self.conv_j = jax.jit(jax_init_cgnn, static_argnums=1)(
            jax.random.PRNGKey(1), small_cfg(False, "conv"))
        self.it_p = to_torch(self.cgnn_j["iterations"][0])
        for lay in (self.it_p["agg"]["hidden"] + [self.it_p["agg"]["out"]]
                    + self.it_p["update"]["hidden"]
                    + [self.it_p["update"]["out"]]):
            lay["b"] = torch.tensor(rng.normal(size=lay["b"].shape),
                                    dtype=torch.float32)
        self.readouts = [to_torch(self.cgnn_j["readout_llrs"][0]),
                         to_torch(self.cgnn_j["readout_chest"])]
        self.s = rng.normal(size=(2, 2, 14, 96, 16)).astype(np.float32)
        self.pe96 = rng.normal(size=(2, 14, 96, 2)).astype(np.float32)
        self.act = np.asarray([[1.0, 1.0], [1.0, 0.0]], np.float32)
        self.y = rng.normal(size=(4, 14, 48, 8)).astype(np.float32)
        self.pe = rng.normal(size=(2, 14, 48, 2)).astype(np.float32)
        self.h = rng.normal(size=(4, 2, 14, 48, 8)).astype(np.float32)
        tp = Parameters("test_small", training=True, config_dir=CFG_DIR)
        self.leaves = checks.flat_leaves(E2EModel(
            tp, training=True, device="cpu").init_params(
                torch.Generator().manual_seed(3)))

    def eval_args(self, **kw):
        return {"config": "test_small", "config_dir": CFG_DIR,
                "weights": weights.NRX_RT_EMA, **kw}

    def train_args(self):
        return {"config": "test_small", "config_dir": CFG_DIR,
                "leaves": self.leaves, "lr": 1e-3, "batch": TRAIN_BATCH,
                "seed": 5}

    def jobs(self, world):
        t = torch.tensor
        jobs = [("stack", {"p": self.stack, "x": t(self.x),
                           "dtype": "float32"}),
                ("iteration", {"it_p": self.it_p, "s": t(self.s),
                               "pe": t(self.pe96), "active": t(self.act),
                               "dtype": "float32"}),
                ("iteration", {"it_p": self.it_p, "s": t(self.s),
                               "pe": t(self.pe96), "active": t(self.act),
                               "readouts": self.readouts,
                               "dtype": "float32"})]
        for data, grid in MESHES[world]:
            jobs.append(("cgnn", {
                "params": to_torch(self.cgnn_j), "cfg": small_cfg(True),
                "y": t(self.y), "pe": t(self.pe), "h": t(self.h),
                "active": torch.ones((4, 2)), "mm": torch.ones((4, 2, 1)),
                "data": data, "grid": grid, "dtype": "float32"}))
        jobs += [("sim_ber", self.eval_args(mode="a", data=2,
                                            grid=world // 2,
                                            kwargs=MESH_SIMBER)),
                 ("sim_ber", self.eval_args(mode="b", kwargs=HOST_SIMBER)),
                 ("train", self.train_args()),
                 ("mesh", {}),
                 ("cgnn", {
                     "params": to_torch(self.conv_j),
                     "cfg": small_cfg(True, "conv"), "y": t(self.y),
                     "pe": t(self.pe), "h": t(self.h),
                     "active": torch.ones((4, 2)),
                     "mm": torch.ones((4, 2, 1)), "data": 1, "grid": world,
                     "dtype": "float32"})]
        return jobs


@pytest.fixture(scope="module")
def inputs():
    return Inputs()


@pytest.fixture(scope="module")
def groups(inputs):
    """{world: future of [per job: [per rank: record]]}: each group started
    once, both at once, while this process computes the references."""
    def run(world):
        ranks = run_ranks("neural_rx_tpu_torch.dist.checks:run_jobs", world,
                          "gloo", {"device": "cpu",
                                   "jobs": inputs.jobs(world)},
                          timeout=300)
        return [list(recs) for recs in zip(*ranks)]
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        yield {world: pool.submit(run, world) for world in WORLDS}


# where each kind's first job stands in `Inputs.jobs`
JOB_INDEX = {w: {"stack": 0, "iteration": 1, "cgnn": 3,
                 "sim_ber": 3 + len(MESHES[w]), "train": 5 + len(MESHES[w]),
                 "mesh": 6 + len(MESHES[w]), "conv": 7 + len(MESHES[w])}
             for w in WORLDS}


def job(groups, world, kind, nth=0):
    """The ranks' records of the nth job of `kind` (waits for the
    group)."""
    return groups[world].result()[JOB_INDEX[world][kind] + nth]


def jax_stack_shards(inputs, world):
    """JAX's sharded stack on a 1 x world mesh, interpret mode."""
    devs = np.asarray(jax.devices()[:world]).reshape(1, world)
    fn = shard_map(partial(jax_stack_sharded, num_shards=world,
                           interpret=True),
                   mesh=JaxMesh(devs, ("data", "grid")),
                   in_specs=(P(), P(None, None, "grid", None)),
                   out_specs=P(None, None, "grid", None), check_rep=False)
    return np.asarray(jax.jit(fn)(inputs.stack_np, jnp.asarray(inputs.x)))


def host_oracle(model, params, n_proc):
    """sim_ber's mode (b) replayed in one process: every rank's stream,
    summed each step, stopped on the global block errors."""
    step = make_eval_step(model)
    kw = HOST_SIMBER
    gens = [multihost.host_generator(kw["seed"], rank=r)
            for r in range(n_proc)]
    rows = []
    for ebno in kw["ebno_dbs"]:
        total = np.zeros(4, np.int64)
        for _ in range(kw["max_mc_iter"]):
            for g in gens:
                total += step(params, g, kw["batch_size"], float(ebno))
            if total[2] >= kw["num_target_block_errors"]:
                break
        rows.append(total)
    return np.asarray(rows)


@pytest.fixture(scope="module")
def refs(inputs, groups):
    """The single-process and JAX results, computed here while the groups
    run."""
    cfg = small_cfg(False)
    b = inputs.y.shape[0]
    llrs, _ = jax.jit(lambda p, y, pe, h: jax_cgnn_apply(
        p, cfg, y, pe, h, jnp.ones((b, 2)), jnp.ones((b, 2, 1))))(
            inputs.cgnn_j, inputs.y, inputs.pe, inputs.h)
    conv_cfg = small_cfg(False, "conv")
    conv_llrs, _ = jax.jit(lambda p, y, pe, h: jax_cgnn_apply(
        p, conv_cfg, y, pe, h, jnp.ones((b, 2)), jnp.ones((b, 2, 1))))(
            inputs.conv_j, inputs.y, inputs.pe, inputs.h)
    model, params = checks.eval_model(inputs.eval_args(),
                                      torch.device("cpu"))
    return {"jax_stack": {w: jax_stack_shards(inputs, w) for w in WORLDS},
            "jax_llr": np.asarray(llrs[-1][0]),
            "jax_conv_llr": np.asarray(conv_llrs[-1][0]),
            "sim_ber": sim_ber(model, params, return_counts=True,
                               verbose=False, **MESH_SIMBER),
            "oracle": {w: host_oracle(model, params, w) for w in WORLDS},
            "step": checks.train_once(inputs.train_args(),
                                      torch.device("cpu"))}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stack_matches_unsharded_and_jax(groups, refs, inputs,
                                                 world):
    want = sepconv_stack_reference(inputs.stack, torch.tensor(inputs.x))
    recs = job(groups, world, "stack")
    got = torch.cat([r["out"] for r in recs], dim=2).numpy()
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, refs["jax_stack"][world], rtol=2e-5,
                               atol=2e-5)
    assert all(r["launches"]["sepconv_stack"] == 0 for r in recs)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["state", "readout"])
def test_sharded_iteration_matches_unsharded(groups, inputs, world, mode):
    recs = job(groups, world, "iteration", nth=int(mode == "readout"))
    readouts = inputs.readouts if mode == "readout" else []
    want = fused_iteration_reference(
        inputs.it_p, torch.tensor(inputs.s), torch.tensor(inputs.pe96),
        torch.tensor(inputs.act), None, *readouts)
    want = want if isinstance(want, tuple) else (want,)
    assert len(recs[0]["out"]) == len(want)
    for i, w in enumerate(want):
        got = torch.cat([r["out"][i] for r in recs], dim=3)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("world,mesh_at", [(w, i) for w in WORLDS
                                           for i in range(2)])
def test_sharded_cgnn_matches_jax(groups, refs, world, mesh_at):
    recs = job(groups, world, "cgnn", nth=mesh_at)
    got = checks.assemble(recs, "llr").numpy()
    want = refs["jax_llr"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    data, grid = MESHES[world][mesh_at]
    assert {r["index"] for r in recs} == {
        (d, g) for d in range(data) for g in range(grid)}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_conv_layers_match_jax(groups, refs, world):
    """Full 3x3 conv layers on a 1 x world mesh: every stack on the shard
    extended by its neighbours' halos (one column a layer), no kernel."""
    recs = job(groups, world, "conv")
    got = checks.assemble(recs, "llr").numpy()
    want = refs["jax_conv_llr"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert {r["index"] for r in recs} == {(0, g) for g in range(world)}


@pytest.mark.parametrize("world", WORLDS)
def test_sim_ber_mesh_equals_single_device(groups, refs, world):
    ber, bler, errs, blocks = refs["sim_ber"]
    assert blocks[0] == 2 * 8 * 2 and 0 < errs[0] < blocks[0]
    for r in job(groups, world, "sim_ber"):
        np.testing.assert_array_equal(r["block_errors"], errs)
        np.testing.assert_array_equal(r["blocks"], blocks)
        np.testing.assert_array_equal(r["ber"], ber)
        np.testing.assert_array_equal(r["bler"], bler)


@pytest.mark.parametrize("world", WORLDS)
def test_sim_ber_processes_match_oracle(groups, refs, world):
    want = refs["oracle"][world]
    per_step = world * HOST_SIMBER["batch_size"] * 2
    # the point stops on the global count: after ceil(20 / per_step) steps
    assert want[0, 3] == per_step * -(-20 // per_step) < 3 * per_step
    assert want[0, 2] > 0
    for r in job(groups, world, "sim_ber", nth=1):
        np.testing.assert_array_equal(r["block_errors"], want[:, 2])
        np.testing.assert_array_equal(r["blocks"], want[:, 3])
        np.testing.assert_array_equal(r["ber"], want[:, 0] / want[:, 1])
    # streams differ across ranks and repeat per rank
    seeds = {multihost.host_seed(11, r) for r in range(world)}
    assert len(seeds) == world
    assert multihost.host_seed(11, 1) == multihost.host_seed(11, 1)


@pytest.mark.parametrize("world", WORLDS)
def test_training_step_identical_across_ranks(groups, refs, inputs, world):
    recs = job(groups, world, "train")
    leaves, losses = refs["step"]
    assert any(not torch.equal(v, inputs.leaves[k])
               for k, v in leaves.items())  # the step moved the parameters
    for r in recs:
        assert r["leaves"].keys() == leaves.keys()
        for k, v in r["leaves"].items():
            assert torch.equal(v, recs[0]["leaves"][k]), k
            np.testing.assert_allclose(v.numpy(), leaves[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r["losses"].numpy(), losses.numpy(),
                                   rtol=1e-5)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_factorisation_as_jax(n):
    data, grid = port_mesh.factor(n)
    assert {"data": data, "grid": grid} == dict(jax_make_mesh(n).shape)


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_in_a_group_as_jax(groups, world):
    for r in job(groups, world, "mesh"):
        assert r["shape"] == dict(jax_make_mesh(world).shape)
    single = port_mesh.make_mesh()
    assert single.shape == {"data": 1, "grid": 1} and single.backend is None
