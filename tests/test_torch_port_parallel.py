"""The port's data-parallel layer on the CPU against the JAX package's
8-device virtual mesh.

Four processes of the port (``tests/torch_dp_rank.py``, gloo, started once
for the module) lay out meshes, take their blocks of batches, run
token-sharded linear attention and serve a DP batch; the test holds what
each process computed against the JAX package's ``parallel`` functions on
its virtual devices (device i against process i) and against the port's
one-process paths. ``pad_batch``, ``distributed_init``'s no-op and errors
and the layouts of an 8-rank mesh are held in this process.
"""

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_diffusion_tpu.data.dataset import shard_files_by_process as jax_shard_files
from cv_diffusion_tpu.models.diffusion import create_model as jax_create_model
from cv_diffusion_tpu.models.diffusion import enhance as jax_enhance
from cv_diffusion_tpu.ops.attention import linear_attention_sharded as jax_la_sharded
from cv_diffusion_tpu.ops.attention import linear_attention_xla
from cv_diffusion_tpu.parallel import mesh as jmesh
from cv_diffusion_tpu_torch import parallel as tpar
from cv_diffusion_tpu_torch.data.dataset import shard_files_by_process
from cv_diffusion_tpu_torch.models import rows
from cv_diffusion_tpu_torch.models.diffusion import enhance, sampler_noise
from cv_diffusion_tpu_torch.weights import state_dict_from_jax

import torch_dp_rank
from test_torch_port_weights import one_torch_thread  # noqa: F401
from test_torch_port_weights import random_jax_params

WORLD = 4
SIZE = 32
SAMPLER_TOL = 5e-3          # the README's sampler tolerance (JAX vs the port)


def _batch():
    rng = np.random.default_rng(3)
    return {"img": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
            "odd_h": rng.standard_normal((8, 33, 33, 3)).astype(np.float32),
            "t": np.arange(8, dtype=np.int32),
            "ragged": rng.standard_normal((3, 4, 4, 3)).astype(np.float32),
            "scalar": np.float32(1.0)}


@pytest.fixture(scope="module")
def case():
    """JAX config, port config and random weights of the tiny UNet at 32²
    (unperturbed norms, as the sampler tests take them)."""
    return random_jax_params("tiny", SIZE, seed=7, perturb_norms=False)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """(inputs, each process's results) of the ``parallel`` task."""
    _, tcfg, params = case
    rng = np.random.default_rng(0)
    qkv = {n: rng.standard_normal((2, 512, 4, 32)).astype(np.float32)
           for n in "qkv"}
    inputs = dict(weights=state_dict_from_jax(params, tcfg), batch=_batch(),
                  low=rng.uniform(-1, 0, (8, SIZE, SIZE, 3)).astype(np.float32),
                  **qkv)
    directory = str(tmp_path_factory.mktemp("dp_parallel"))
    return inputs, torch_dp_rank.spawn("parallel", directory, inputs, WORLD)


@pytest.fixture
def four_jax_devices(monkeypatch):
    """``jax.devices()`` as the first four virtual devices: the JAX
    functions that lay out every device then see the port's four
    processes."""
    devices = jax.devices()[:WORLD]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
    return devices


def _ids(devices) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(np.asarray(devices))


@pytest.mark.parametrize("shape", [None, (4,), (4, 1), (2, 2), (1, 4)])
def test_mesh_matches_jax(ranks, shape):
    """Shape, axis names, the ranks' layout (device i is process i) and
    each process's coordinates against ``make_mesh`` over four devices."""
    want = jmesh.make_mesh(shape, devices=jax.devices()[:WORLD])
    for rank, res in enumerate(ranks[1]):
        got_shape, names, devices, coords = res["meshes"][shape]
        assert got_shape == dict(want.shape) and names == want.axis_names
        np.testing.assert_array_equal(devices, _ids(want.devices))
        where = np.argwhere(_ids(want.devices) == rank)[0]
        assert coords == dict(zip(want.axis_names, where.tolist()))


def test_mesh_errors_and_auto_mesh_match_jax(ranks, four_jax_devices):
    """``make_mesh``'s and ``make_hybrid_mesh``'s errors word for word, and
    ``auto_mesh``'s largest divisor (not the gcd) for each batch size."""
    devs = four_jax_devices
    calls = {"uncovered": lambda: jmesh.make_mesh((3, 2), devices=devs),
             "3d": lambda: jmesh.make_mesh((2, 2, 1), devices=devs),
             "names": lambda: jmesh.make_mesh((4,), ("data", "spatial"), devs),
             "hybrid_covers": lambda: jmesh.make_hybrid_mesh((2, 1), (1, 1)),
             "hybrid_rank": lambda: jmesh.make_hybrid_mesh((2, 2, 2), (1, 1))}
    for name, call in calls.items():
        with pytest.raises(ValueError) as err:
            call()
        for res in ranks[1]:
            assert res["errors"][name] == f"ValueError: {err.value}", name
    for batch in (12, 6, 3, 64, 1):
        want = jmesh.auto_mesh(batch)
        for res in ranks[1]:
            got = res["auto"][batch]
            if want is None:
                assert got is None
                continue
            assert got[0] == dict(want.shape)
            np.testing.assert_array_equal(got[1], _ids(want.devices))
    assert ranks[1][0]["auto"][12][0]["data"] == 4     # not gcd(4, 12) …
    assert ranks[1][0]["auto"][6][0]["data"] == 3      # … but 3 of 4


def test_hybrid_mesh_layout(ranks, four_jax_devices):
    """An all-ones DCN grid is ``make_hybrid_mesh``'s plain mesh; with two
    blocks of two ranks on the DCN the data axis spans the blocks and each
    data row is one block of consecutive ranks (one host when a host runs
    two processes), as each row of JAX's is one process
    (``test_distributed_multiprocess.py``)."""
    want = jmesh.make_hybrid_mesh((2, 2), (1, 1))
    for res in ranks[1]:
        shape, names, devices, _ = res["meshes"]["hybrid_ici"]
        assert shape == dict(want.shape) and names == want.axis_names
        np.testing.assert_array_equal(devices, _ids(want.devices))
        shape, _, devices, _ = res["meshes"]["hybrid_dcn"]
        assert shape == {"data": 2, "spatial": 2}
        np.testing.assert_array_equal(devices, [[0, 1], [2, 3]])


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_shard_batch_matches_jax_addressable_shards(ranks, shape):
    """Each process's block of every leaf (the fallbacks included: a [B]
    vector over data only, an odd height over data only, a batch of 3 and
    a scalar whole) against the shard JAX's ``shard_batch`` puts on that
    process's device."""
    mesh = jmesh.make_mesh(shape, devices=jax.devices()[:WORLD])
    want = jmesh.shard_batch(mesh, _batch())
    for rank, res in enumerate(ranks[1]):
        for name, arr in want.items():
            shard, = [s for s in arr.addressable_shards if s.device.id == rank]
            np.testing.assert_array_equal(res["shard"][shape][name],
                                          np.asarray(shard.data), err_msg=name)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_shard_batch_on_eight_ranks_matches_jax(shape):
    """On a layout of eight ranks (no process group), rank r's block of
    each leaf equals JAX's shard on device r of the 8-device mesh."""
    mesh = tpar.make_mesh(shape, devices=list(range(8)))
    jm = jmesh.make_mesh(shape)
    assert dict(mesh.shape) == dict(jm.shape)
    np.testing.assert_array_equal(mesh.devices, _ids(jm.devices))
    want = jmesh.shard_batch(jm, _batch())
    for rank in range(8):
        got = tpar.shard_batch(mesh, _batch(), rank=rank)
        for name, arr in want.items():
            shard, = [s for s in arr.addressable_shards if s.device.id == rank]
            np.testing.assert_array_equal(got[name], np.asarray(shard.data))
    assert tpar.batch_sharding(mesh).spec == tuple(
        a for a in jmesh.batch_sharding(jm).spec)
    assert tpar.replicated_sharding(mesh).spec == ()


@pytest.mark.parametrize("batch,multiple", [
    ({"a": np.arange(5 * 4 * 4 * 3, dtype=np.float32).reshape(5, 4, 4, 3)}, 8),
    ({"a": np.arange(5 * 2).reshape(5, 2), "b": np.arange(5)}, 5),
    ({"b": np.arange(6), "a": np.ones((6, 2))}, 4),
    ({}, 8),
    ({"img": np.zeros((6, 4)), "step": np.int64(3)}, 8),
    ({"a": np.zeros((6, 4)), "b": np.zeros((5, 4))}, 8),
])
def test_pad_batch_matches_jax(batch, multiple):
    try:
        want = jmesh.pad_batch(batch, multiple)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tpar.pad_batch(batch, multiple)
        assert str(got.value) == str(err)
        return
    got = tpar.pad_batch(batch, multiple)
    assert got[1] == want[1]
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], np.asarray(want[0][k]))


def test_distributed_init_matches_jax(monkeypatch, ranks):
    """No environment: a no-op returning False on both sides; a
    coordinator without the process count and id: the same ValueError;
    ``CVDM_DISTRIBUTED=1`` without ``torch.distributed.run``'s environment
    raises (JAX would ask the TPU metadata). Each of the four processes
    joined through it, and a second call returns True."""
    for var in ("CVDM_COORDINATOR", "CVDM_DISTRIBUTED", "CVDM_NUM_PROCESSES",
                "CVDM_PROCESS_ID", "RANK", "WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert jmesh.distributed_init() is False
    assert tpar.distributed_init(device="cpu") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="CVDM_NUM_PROCESSES") as want:
        jmesh.distributed_init(coordinator_address="host:1234")
    with pytest.raises(ValueError) as got:
        tpar.distributed_init(coordinator_address="host:1234", device="cpu")
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("CVDM_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="CVDM_PROCESS_ID"):
        tpar.distributed_init(coordinator_address="host:1234", device="cpu")
    monkeypatch.setenv("CVDM_DISTRIBUTED", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tpar.distributed_init(device="cpu")
    assert all(res["errors"]["init_again"] is True for res in ranks[1])


@pytest.fixture(scope="module")
def jax_attention(ranks):
    inputs, _ = ranks
    q, k, v = (jnp.asarray(inputs[n]) for n in "qkv")
    mesh = jmesh.make_mesh((1, 8))
    spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "spatial"))
    sharded = jax.jit(lambda a, b, c: jax_la_sharded(a, b, c, mesh=mesh))(
        *(jax.device_put(x, spec) for x in (q, k, v)))
    return np.asarray(sharded), np.asarray(linear_attention_xla(q, k, v))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_linear_attention_sharded_matches_jax(ranks, jax_attention, shape):
    """Token-sharded linear attention over spatial groups of 2 (mesh
    (2, 2)) and 4 (mesh (1, 4)) at [2, 512, 4, 32]: each process's tokens
    against JAX's ``linear_attention_sharded`` on ``make_mesh((1, 8))``
    and its ``linear_attention_xla``, 2e-5 (``test_parallel.py:188``)."""
    sharded, whole = jax_attention
    for res in ranks[1]:
        _, _, devices, coords = res["meshes"][shape]
        n = 512 // shape[1]
        tokens = slice(coords["spatial"] * n, (coords["spatial"] + 1) * n)
        got = res["attention"][shape]
        np.testing.assert_allclose(got, sharded[:, tokens], atol=2e-5, rtol=0)
        np.testing.assert_allclose(got, whole[:, tokens], atol=2e-5, rtol=0)


def test_dp_serving_matches_enhance_and_jax(case, ranks, one_torch_thread):  # noqa: F811
    """The DP sampler at four processes, 2 rows each of a batch of 8, its
    noise drawn for the global batch from one generator: each process's
    rows equal the port's ``enhance`` of those rows on those rows of the
    global noise bit for bit, a state dict and a ``{"params": ...}`` dict
    alike; ``gather`` puts them in rank order; the whole batch agrees with
    the one-process ``enhance`` at batch 8 (the CPU's sgemm rounds a row
    differently at 2 rows than at 8: ``time_mlp``'s Linear is the first op
    to differ) and with JAX's ``enhance`` on the same noise, each within
    the sampler tolerance 5e-3."""
    jcfg, tcfg, params = case
    inputs, results = ranks
    model, schedule = torch_dp_rank.tiny(inputs)
    low = torch.from_numpy(inputs["low"])
    init, step = sampler_noise(torch.Generator().manual_seed(5),
                               (8, SIZE, SIZE, 3), 2, "cpu")
    for rank, res in enumerate(results):
        part = slice(2 * rank, 2 * rank + 2)
        want = enhance(model, schedule, low[part], num_inference_steps=2,
                       init_noise=init[part], step_noise=step[:, part],
                       device="cpu").numpy()
        assert np.array_equal(res["serve"]["local"], want), rank
        assert np.array_equal(res["serve"]["again"], want), rank
        with rows.global_batch(8, part.start, part.stop):
            drawn = sampler_noise(torch.Generator().manual_seed(5),
                                  (2, SIZE, SIZE, 3), 2, "cpu")
        assert torch.equal(drawn[0], init[part]) and torch.equal(drawn[1], step[:, part])
    whole = results[0]["serve"]["whole"]
    np.testing.assert_array_equal(
        whole, np.concatenate([r["serve"]["local"] for r in results]))
    assert all(np.array_equal(r["serve"]["whole"], whole) for r in results)
    one = enhance(model, schedule, low, num_inference_steps=2,
                  generator=torch.Generator().manual_seed(5), device="cpu")
    np.testing.assert_allclose(whole, one.numpy(), atol=SAMPLER_TOL, rtol=0)
    jmodel, jschedule = jax_create_model(jcfg)
    ref = jax_enhance(jmodel, jschedule, {"params": params}, jax.random.key(0),
                      jnp.asarray(inputs["low"]), num_inference_steps=2,
                      init_noise=jnp.asarray(init.numpy()),
                      step_noise=jnp.asarray(step.numpy()))
    np.testing.assert_allclose(whole, np.asarray(ref), atol=SAMPLER_TOL, rtol=0)


def test_make_sample_fn_is_enhance(ranks, one_torch_thread):  # noqa: F811
    """``export.serving.make_sample_fn`` (JAX ``make_sample_fn``): a bare
    state dict or a ``{"params": ...}`` dict, the noise from the generator,
    equals ``enhance`` with those parameters bit for bit, in float32."""
    from cv_diffusion_tpu_torch.export.serving import make_sample_fn

    inputs, _ = ranks
    model, schedule = torch_dp_rank.tiny(inputs)
    low = torch.from_numpy(inputs["low"][:2])
    fn = make_sample_fn(model, schedule, 2)
    want = enhance(model, schedule, low, num_inference_steps=2,
                   generator=torch.Generator().manual_seed(1), device="cpu")
    for params in (inputs["weights"], {"params": inputs["weights"]}):
        got = fn(params, torch.Generator().manual_seed(1), low)
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_shard_files_by_process_matches_jax(ranks):
    """Each process's file shard (strided, truncated to equal length), and
    the function's other cases and errors."""
    for rank, res in enumerate(ranks[1]):
        assert res["files"] == jax_shard_files(list(range(10)), rank, WORLD)
    for n, pid, procs in itertools.product((1, 7, 8), (0, 1, 2, 3), (1, 2, 3)):
        try:
            want = jax_shard_files(list(range(n)), pid, procs)
        except ValueError as err:
            with pytest.raises(ValueError, match=re.escape(str(err))):
                shard_files_by_process(list(range(n)), pid, procs)
            continue
        assert shard_files_by_process(list(range(n)), pid, procs) == want


def test_spatial_axis_on_a_unet_path_runs(ranks):
    """The sampler on a (2, 2) mesh (a spatial axis of two processes, which
    the port once refused) serves the DP batch: each process its two rows
    and 16 image rows, eagerly (no CUDA graph), gathered into the batch
    that the data-parallel sampler serves, within the sampler tolerance
    (float32 at other row counts; ``test_torch_port_spatial.py`` holds the
    spatial path to JAX and to the one-process sampler)."""
    _, results = ranks
    whole = results[0]["serve"]["whole"]
    for res in results:
        assert res["spatial_serve"]["graphs"] == {}
        assert res["spatial_serve"]["local"].shape == (4, SIZE // 2, SIZE, 3)
        np.testing.assert_array_equal(res["spatial_serve"]["whole"],
                                      results[0]["spatial_serve"]["whole"])
    np.testing.assert_allclose(results[0]["spatial_serve"]["whole"], whole,
                               atol=SAMPLER_TOL, rtol=0)


def test_spatial_axis_refuses_int8_serving_by_name(ranks):
    """What a spatial axis does not serve names ROADMAP item 8c: an
    ``act_quant`` model (its dynamic amax would need a max over the
    group)."""
    inputs, _ = ranks
    model, schedule = torch_dp_rank.tiny(inputs, act_quant=True)
    mesh = tpar.make_mesh((1, 2), devices=[0, 1])
    with pytest.raises(NotImplementedError, match="item 8c"):
        tpar.make_sharded_sample_fn(model, schedule, 2, mesh=mesh)
