"""The numpy training modules the port copies (`buckets`, `sampler`,
`datasets`) against the originals: the same seeds give the same bucket
assignments, batch plans, resume state, frame masks and dummy latents."""

import numpy as np
import pytest

from videosys_tpu.training import buckets as JB
from videosys_tpu.training import datasets as JD
from videosys_tpu.training import sampler as JS
from videosys_tpu_torch.training import buckets as PB
from videosys_tpu_torch.training import datasets as PD
from videosys_tpu_torch.training import sampler as PS
from videosys_tpu_torch.training.train import (
    DEFAULT_BUCKET_CONFIG,
    DEFAULT_MASK_RATIOS,
    latent_size,
)

BUCKETS = {
    "default": DEFAULT_BUCKET_CONFIG,
    "two_level": {"144p": {1: (1.0, 4), 51: ((1.0, 0.5), 2)},
                  "480p": {1: (0.7, 2), 102: ((0.5, 0.8), 1)}},
}


def _plans(mod_s, mod_b, mod_d, config, seed, **kw):
    ds = mod_d.DummyVariableVideoTextDataset(size=200, seed=seed)
    sampler = mod_s.VariableVideoBatchSampler(
        mod_b.Bucket(config), ds.shapes(), seed=seed, **kw)
    return ds, sampler


@pytest.mark.parametrize("name", sorted(BUCKETS))
@pytest.mark.parametrize("seed", [0, 7])
def test_plans_match_the_original(name, seed):
    planner_profile = {("144p", 51, "0.56"): {"time": 0.2, "sp": 2, "bs": 3,
                                              "remat_policy": "dots"}}
    for planner in (None, "dcp"):
        kw = {}
        for mod_s, store in ((JS, "j"), (PS, "p")):
            if planner:
                kw[store] = dict(planner=mod_s.DCPPlanner(
                    planner_profile, target_time=0.4), drop_last=False)
            else:
                kw[store] = {}
        jds, js = _plans(JS, JB, JD, BUCKETS[name], seed, **kw["j"])
        pds, ps = _plans(PS, PB, PD, BUCKETS[name], seed, **kw["p"])
        assert jds.shapes() == pds.shapes()
        for epoch in (0, 1):
            js.set_epoch(epoch)
            ps.set_epoch(epoch)
            want, got = list(js), list(ps)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert (g.bucket_id, g.indices, g.sp_size, g.gas, g.thw) == \
                    (w.bucket_id, w.indices, w.sp_size, w.gas, w.thw)
                assert g.micro_batches() == w.micro_batches()
            assert ps.effective_samples == js.effective_samples
            assert ps.last_bucket_stats == js.last_bucket_stats
        assert len(ps) == len(js)


def test_resume_state_matches_the_original():
    _, js = _plans(JS, JB, JD, DEFAULT_BUCKET_CONFIG, 3)
    _, ps = _plans(PS, PB, PD, DEFAULT_BUCKET_CONFIG, 3)
    all_plans = list(ps)
    assert ps.state_dict(3) == js.state_dict(3)
    _, resumed = _plans(PS, PB, PD, DEFAULT_BUCKET_CONFIG, 3)
    resumed.seed = 99  # the saved state brings the seed back
    resumed.load_state_dict(ps.state_dict(3))
    rest = list(resumed)
    assert len(rest) == len(all_plans) - 3
    assert rest[0].indices == all_plans[3].indices
    assert resumed.start_index == 0  # consumed by the first pass


def test_planner_and_packing_match_the_original():
    prof = {("144p", 34, "1.00"): {"time": 0.1, "sp": 1},
            ("240p", 51, "1.00"): {"time": 0.4, "sp": 2, "bs": 6,
                                   "remat_policy": "none"}}
    jp, pp = JS.DCPPlanner(prof, 0.4), PS.DCPPlanner(prof, 0.4)
    for bid in (("144p", 34, "1.00"), ("240p", 51, "0.56"), ("999p", 1, "x")):
        assert pp.plan(bid) == jp.plan(bid)
        assert pp.remat_policy(bid) == jp.remat_policy(bid)
        assert pp.bs(bid) == jp.bs(bid)
    assert pp.plan(("144p", 34, "1.00")) == (1, 4)
    plans = [(("144p", 34, "1.00"), 1, 2), (("240p", 51, "1.00"), 2, 1),
             (("144p", 34, "1.00"), 1, 1), (("240p", 51, "1.00"), 2, 3)]
    jg = JS.pack_global_steps(
        [JS.BatchPlan(b, [0], sp, gas) for b, sp, gas in plans], 4, prof)
    pg = PS.pack_global_steps(
        [PS.BatchPlan(b, [0], sp, gas) for b, sp, gas in plans], 4, prof)
    assert [([p.bucket_id for p in g.plans], g.est_times, g.imbalance)
            for g in pg] == \
        [([p.bucket_id for p in g.plans], g.est_times, g.imbalance) for g in jg]


@pytest.mark.parametrize("T", [1, 5, 15])
def test_masks_and_latents_match_the_original(T):
    jm, pm = JD.MaskGenerator(DEFAULT_MASK_RATIOS), PD.MaskGenerator(DEFAULT_MASK_RATIOS)
    for seed in (0, 5):
        np.testing.assert_array_equal(pm(16, T, seed=seed), jm(16, T, seed=seed))
    mixed = {"identity": 0.2, "random": 0.2, "mask_head": 0.2, "mask_tail": 0.1,
             "mask_head_tail": 0.1, "interpolate": 0.1, "quarter_head_tail": 0.1}
    np.testing.assert_array_equal(PD.MaskGenerator(mixed)(32, T, seed=1),
                                  JD.MaskGenerator(mixed)(32, T, seed=1))
    jds = JD.DummyVariableVideoTextDataset(size=8, seed=2, distribution="uniform")
    pds = PD.DummyVariableVideoTextDataset(size=8, seed=2, distribution="uniform")
    assert pds.shapes() == jds.shapes() and len(pds) == 8
    np.testing.assert_array_equal(
        pds.load_latents([0, 3], (T, 4, 6), rng_seed=9),
        jds.load_latents([0, 3], (T, 4, 6), rng_seed=9))
    np.testing.assert_array_equal(PD.temporal_random_crop(40, 8, 2, seed=3),
                                  JD.temporal_random_crop(40, 8, 2, seed=3))


def test_bucket_lookup_matches_the_original():
    jb, pb = JB.Bucket(BUCKETS["two_level"]), PB.Bucket(BUCKETS["two_level"])
    assert len(pb) == len(jb)
    rng = np.random.default_rng(0)
    for _ in range(200):
        T = int(rng.choice([1, 20, 51, 102, 130]))
        H, W = (int(v) for v in rng.choice([144, 256, 480, 854, 1080], size=2))
        seed = int(rng.integers(0, 50))
        want = jb.get_bucket_id(T, H, W, seed=seed)
        got = pb.get_bucket_id(T, H, W, seed=seed)
        assert got == want
        if got is not None:
            assert pb.get_thw(got) == jb.get_thw(got)
            assert pb.get_batch_size(got) == jb.get_batch_size(got)


def test_latent_size_follows_the_vae_factors():
    assert latent_size((51, 240, 426)) == (15, 30, 53)
    assert latent_size((1, 1080, 1920)) == (1, 135, 240)
    assert latent_size((34, 144, 256)) == (10, 18, 32)


def test_preprocessed_latent_dataset_reads_numpy_files(tmp_path):
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(3):
        lat = rng.standard_normal((4, 5, 6, 8)).astype(np.float32)
        np.save(tmp_path / f"latent_{i}.npy", lat)
        np.savez(tmp_path / f"text_{i}.npz",
                 y=rng.standard_normal((8, 16)).astype(np.float32),
                 mask=np.arange(8) < 3 + i)
        rows.append({"num_frames": 17, "height": 48, "width": 64, "text": f"t{i}",
                     "latent_path": str(tmp_path / f"latent_{i}.npy"),
                     "text_path": str(tmp_path / f"text_{i}.npz")})
    pd.DataFrame(rows).to_csv(tmp_path / "preprocessed.csv", index=False)
    ds = PD.PreprocessedLatentDataset(str(tmp_path / "preprocessed.csv"))
    assert len(ds) == 3 and ds.shapes() == [(17, 48, 64)] * 3
    lat = ds.load_latents([2, 0], (5, 6, 8))
    assert lat.shape == (2, 4, 5, 6, 8) and lat.dtype == np.float32
    np.testing.assert_array_equal(lat[1], np.load(tmp_path / "latent_0.npy"))
    y, mask = ds.text_embeds([1])
    assert y.shape == (1, 8, 16) and mask.sum() == 4
    with pytest.raises(ValueError):
        ds.load_latents([0], (5, 6, 9))
