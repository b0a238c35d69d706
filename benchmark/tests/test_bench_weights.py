"""Each tree `weights.py` makes has exactly the keys and shapes that the
port's `interop/from_jax` makers give at the same configuration."""

import torch

from benchmark import harness, weights


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    elif isinstance(tree, torch.nn.GRU):
        names = {"weight_ih_l0": "w_ih", "weight_hh_l0": "w_hh", "bias_ih_l0": "b_ih",
                 "bias_hh_l0": "b_hh", "weight_ih_l0_reverse": "w_ih_r",
                 "weight_hh_l0_reverse": "w_hh_r", "bias_ih_l0_reverse": "b_ih_r",
                 "bias_hh_l0_reverse": "b_hh_r"}
        for attr, key in names.items():
            yield f"{path[:-len('/gru')]}/gru_raw/{key}", tuple(getattr(tree, attr).shape)
    else:
        yield path, tuple(tree.shape)


def _config(name):
    return harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json")


def _port_cfg(config):
    from rvc_maker_tpu_torch.config import preset

    cfg = preset("v2", config["sample_rate"]).model
    return cfg


def test_synthesizer_trees_match_the_port():
    from rvc_maker_tpu_torch.interop import from_jax

    for name in ("rvc-v2-48k", "rvc-v2-40k"):
        config = _config(name)
        cfg = _port_cfg(config)
        for train in (False, True):
            port = from_jax.synthesizer_from_jax(from_jax.random_synthesizer_tree(cfg, 0), cfg,
                                                 train=train)
            assert dict(_flat(port)) == weights.spec_shapes(
                weights.synthesizer_spec(config["model"], train=train)), (name, train)


def test_hubert_rmvpe_discriminator_trees_match_the_port():
    from rvc_maker_tpu_torch.interop import from_jax

    config = _config("rvc-v2-48k")
    assert dict(_flat(from_jax.hubert_from_jax(from_jax.random_hubert_tree(0)))) == \
        weights.spec_shapes(weights.hubert_spec(config["hubert"]))
    assert dict(_flat(from_jax.rmvpe_from_jax(from_jax.random_rmvpe_tree(0)))) == \
        weights.spec_shapes(weights.rmvpe_spec(config["rmvpe"]))
    assert dict(_flat(from_jax.discriminator_from_jax(
        from_jax.random_discriminator_tree("v2", 1, 0)))) == \
        weights.spec_shapes(weights.discriminator_spec("v2"))


def test_materialize_is_seeded_and_scaled():
    spec = {"a": weights._u((64, 32), 32), "b": weights._n((1000,), 0.5),
            "c": weights._zeros((3,)), "wn": weights._wn((8, 4, 5))}
    x, y = weights.materialize(spec, 2 ** 31 + 1, "cpu"), weights.materialize(spec, 2 ** 31 + 1, "cpu")
    z = weights.materialize(spec, 2, "cpu")
    assert torch.equal(x["a"], y["a"]) and not torch.equal(x["a"], z["a"])
    assert x["a"].abs().max() <= 32 ** -0.5 and abs(float(x["b"].std()) - 0.5) < 0.05
    assert torch.equal(x["c"], torch.zeros(3))
    torch.testing.assert_close(x["wn"]["g"][:, 0, 0], x["wn"]["v"].flatten(1).norm(dim=1))
