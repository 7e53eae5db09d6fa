"""Auto3DSeg's engine side in monai_tpu_torch (``auto3dseg``), on the CPU, against
monai_tpu's.

- ``SegSummarizer`` (connected components and a histogram on) over two 20x18x16 phantoms
  of two classes, each loaded by its package's ``LoadImaged``, and each case analyzer
  and summary analyzer on its own: shapes, counts, labels, components and histogram
  counts exactly, intensities within 1e-6 relative to max(|ref|, 1) (the port reduces
  tensors: float64 sums, float64 interpolation between float32 order statistics; numpy
  sums float32).
- ``SampleOperations`` on a tensor of more than 2^24 elements (past ``torch.quantile``'s
  limit): the percentiles and the median numpy's ``percentile`` of the float32 values
  within 1e-12 relative, the mean and stdev float64's, and every statistic within 1e-6
  of the JAX package's, relative to the values' mean magnitude.
- ``ImageHistogram`` with values on the bin edges, below and above the range: numpy's
  counts exactly.
- The utilities (foreground, connected components, concatenation of report values, the
  datalist's folds, the report format, the pickles, the python-fire strings).
- ``StrEnum`` values dump to yaml as plain strings, as the JAX package's.
"""
import os

import numpy as np
import pytest
import torch
import yaml

import monai_tpu.apps.auto3dseg  # noqa: F401  (registers the JAX package's yaml representer)
import monai_tpu.auto3dseg as jax_a3d
import monai_tpu.auto3dseg.utils as jax_utils
import monai_tpu.transforms as jax_transforms
from monai_tpu.utils.enums import DataStatsKeys as JaxDataStatsKeys
import monai_tpu_torch.apps.auto3dseg  # noqa: F401  (registers the port's yaml representer)
import monai_tpu_torch.auto3dseg as a3d
import monai_tpu_torch.auto3dseg.utils as port_utils
import monai_tpu_torch.transforms as transforms
from monai_tpu_torch.data import write_nifti
from monai_tpu_torch.data.synthetic import create_test_image_3d
from monai_tpu_torch.utils import DataStatsKeys, ImageStatsKeys, LabelStatsKeys

KEYS = ["image", "label"]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Two phantoms with three labels, loaded channel-first by each package."""
    root = tmp_path_factory.mktemp("summ")
    rs = np.random.RandomState(0)
    items = []
    for i in range(2):
        im, seg = create_test_image_3d(20, 18, 16, num_objs=4, rad_max=6, rad_min=2, num_seg_classes=2,
                                       random_state=rs)
        items.append({"image": str(root / f"img{i}.nii.gz"), "label": str(root / f"seg{i}.nii.gz")})
        write_nifti((im * 3.7 + 0.4).astype(np.float32), items[-1]["image"], affine=np.diag([1.5, 0.8, 2.0, 1.0]))
        write_nifti(seg.astype(np.uint8), items[-1]["label"], affine=np.diag([1.5, 0.8, 2.0, 1.0]))
    jax_load = jax_transforms.Compose([jax_transforms.LoadImaged(keys=KEYS),
                                       jax_transforms.EnsureChannelFirstd(keys=KEYS, channel_dim="no_channel")])
    load = transforms.Compose([transforms.LoadImaged(keys=KEYS, device="cpu"),
                               transforms.EnsureChannelFirstd(keys=KEYS, channel_dim="no_channel")])
    return [jax_load(dict(it)) for it in items], [load(dict(it)) for it in items]


def _close(got, ref, path=""):
    """Equal, but for intensities: within 1e-6 of max(|ref|, 1), as the images' values are
    of order 1 and numpy's float32 sums err relative to them (a stdev of one value is
    ~3e-8 there, 0 in the port's float64); numpy integers are ints."""
    if isinstance(ref, dict):
        assert set(map(str, got)) == set(map(str, ref)), path
        for k in ref:
            _close(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref), (path, got, ref)
        for i, (a, b) in enumerate(zip(got, ref)):
            _close(a, b, f"{path}[{i}]")
    elif isinstance(ref, float) and "intensity" in path:
        assert type(got) is float and abs(got - ref) <= 1e-6 * max(abs(ref), 1.0), (path, got, ref)
    else:
        ref = int(ref) if isinstance(ref, np.integer) else ref
        assert got == ref and type(got) is type(ref), (path, got, ref)


def _reports(data: dict) -> dict:
    return {str(k): v for k, v in data.items() if k not in KEYS}


def test_seg_summarizer_matches_jax(cases):
    jax_cases, port_cases = cases
    kw = dict(do_ccp=True, hist_bins=[12], hist_range=[-0.5, 3.5])
    ref_s, s = jax_a3d.SegSummarizer("image", "label", **kw), a3d.SegSummarizer("image", "label", **kw)
    ref = [ref_s(c) for c in jax_cases]
    got = [s(c) for c in port_cases]
    for g, r in zip(got, ref):
        _close(_reports(g), _reports(r))
    assert got[0][DataStatsKeys.LABEL_STATS][LabelStatsKeys.LABEL_UID] == [0, 1, 2]
    _close(s.summarize(got), ref_s.summarize(ref))


CASE_ANALYZERS = {
    "image": lambda m: m.ImageStats("image"),
    "foreground": lambda m: m.FgImageStats("image", "label"),
    "label": lambda m: m.LabelStats("image", "label", do_ccp=False),
    "label_ccp": lambda m: m.LabelStats("image", "label", do_ccp=True),
    "filename": lambda m: m.FilenameStats("image", "image_filepath"),
    "histogram": lambda m: m.ImageHistogram("image", hist_bins=7, hist_range=[0.0, 3.0]),
}
SUMMARIES = {"image": lambda m: m.ImageStatsSumm(), "foreground": lambda m: m.FgImageStatsSumm(),
             "label": lambda m: m.LabelStatsSumm(), "label_ccp": lambda m: m.LabelStatsSumm(do_ccp=True),
             "histogram": lambda m: m.ImageHistogramSumm()}


@pytest.mark.parametrize("name", sorted(CASE_ANALYZERS))
def test_case_analyzer_and_its_summary_match_jax(cases, name):
    jax_cases, port_cases = cases
    ref_a, a = CASE_ANALYZERS[name](jax_a3d), CASE_ANALYZERS[name](a3d)
    ref = [ref_a(c) for c in jax_cases]
    got = [a(c) for c in port_cases]
    assert a.stats_name == ref_a.stats_name and a.get_report_format().keys() == ref_a.get_report_format().keys()
    for g, r in zip(got, ref):
        _close(g[a.stats_name], r[ref_a.stats_name], name)
    if name in SUMMARIES:
        _close(SUMMARIES[name](a3d)(got), SUMMARIES[name](jax_a3d)(ref), name)


def test_sample_operations_past_quantiles_limit():
    """2^24 + 7 float32 values: torch.quantile refuses them; the port's sort does not."""
    x = np.random.RandomState(1).standard_normal(2 ** 24 + 7).astype(np.float32) * 50 + 3
    got = a3d.SampleOperations().evaluate(torch.from_numpy(x))
    ref = jax_a3d.SampleOperations().evaluate(x)
    assert got.keys() == ref.keys()
    x64 = x.astype(np.float64)
    exact = np.percentile(x64, [0.5, 10, 90, 99.5]).tolist()
    np.testing.assert_allclose(got["percentile"], exact, rtol=1e-12)
    np.testing.assert_allclose(got["median"], np.median(x64), rtol=1e-12)
    np.testing.assert_allclose([got["mean"], got["stdev"]], [x64.mean(), x64.std()], rtol=1e-12)
    assert got["max"] == ref["max"] and got["min"] == ref["min"]
    scale = float(np.abs(x64).mean())  # numpy's float32 sums err relative to the values' size
    for k in ref:
        assert np.abs(np.subtract(got[k], ref[k])).max() <= 1e-6 * max(np.abs(ref[k]).max(), scale), k


def test_histogram_counts_values_on_the_edges_as_numpy():
    edges = np.histogram_bin_edges(np.empty(0, np.float32), bins=10, range=(-0.3, 0.7))
    on_edges = edges.astype(np.float32)
    beside = np.concatenate([np.nextafter(on_edges, np.float32(-1)), np.nextafter(on_edges, np.float32(1))])
    outside = np.float32([-0.31, 0.71, -5.0, 5.0])
    values = np.concatenate([on_edges, beside, outside, np.random.RandomState(2).rand(500).astype(np.float32)])
    image = values.reshape(1, -1, 1, 1)
    ref = jax_a3d.ImageHistogram("image", hist_bins=10, hist_range=[-0.3, 0.7])({"image": image})
    got = a3d.ImageHistogram("image", hist_bins=10, hist_range=[-0.3, 0.7])({"image": torch.from_numpy(image)})
    counts, bin_edges = np.histogram(values, bins=10, range=(-0.3, 0.7))
    assert got["image_histogram"][0]["counts"] == counts.tolist() == ref["image_histogram"][0]["counts"]
    assert got["image_histogram"][0]["bin_edges"] == bin_edges.tolist() == ref["image_histogram"][0]["bin_edges"]


def test_foreground_and_components_match_jax(cases):
    jax_cases, port_cases = cases
    (jc, pc) = jax_cases[0], port_cases[0]
    np.testing.assert_array_equal(port_utils.get_foreground_label(pc["image"], pc["label"]).numpy(),
                                  np.asarray(jax_utils.get_foreground_label(jc["image"], jc["label"])))
    fg, fg_ref = port_utils.get_foreground_image(pc["label"]), jax_utils.get_foreground_image(jc["label"])
    np.testing.assert_array_equal(fg.data.numpy(), np.asarray(fg_ref.data))
    assert port_utils.get_label_ccp(pc["label"].data[0]) == jax_utils.get_label_ccp(np.asarray(jc["label"].data)[0])


def test_report_utilities_match_jax(tmp_path):
    reports = [{"a": {"b": [1.0, 2.0], "c": 3}}, {"a": {"b": [4.0, 5.0], "c": 6}}]
    for kw in ({}, {"ragged": True}, {"axis": None}):
        np.testing.assert_array_equal(port_utils.concat_val_to_np(reports, ["a", "b"], **kw),
                                      jax_utils.concat_val_to_np(reports, ["a", "b"], **kw))
    got = port_utils.concat_multikeys_to_dict([{"s": [{"x": 1, "y": 2}]}] * 2, ["s"], ["x", "y"])
    ref = jax_utils.concat_multikeys_to_dict([{"s": [{"x": 1, "y": 2}]}] * 2, ["s"], ["x", "y"])
    assert {k: v.tolist() for k, v in got.items()} == {k: v.tolist() for k, v in ref.items()}
    datalist = {"training": [{"image": f"i{i}.nii", "label": f"l{i}.nii", "fold": i % 3} for i in range(7)]}
    assert port_utils.datafold_read(datalist, "/data", fold=1) == jax_utils.datafold_read(datalist, "/data", fold=1)
    fmt = {"stats_by_cases": [{"image_stats": None}], "stats_summary": None}
    for report in ({"stats_by_cases": [{"image_stats": 1}], "stats_summary": 2}, {"stats_summary": 2},
                   {"stats_by_cases": [{"label": 1}], "stats_summary": 2}):
        assert port_utils.verify_report_format(report, fmt) == jax_utils.verify_report_format(report, fmt)
    params = {"lr": 0.1, "roi": [96, 96, 64], "name": "x"}
    assert port_utils.check_and_set_optional_args(params) == jax_utils.check_and_set_optional_args(params)
    assert port_utils.list_to_python_fire_arg_str([1, 2]) == jax_utils.list_to_python_fire_arg_str([1, 2])


class _Stub(a3d.Algo):
    def __init__(self, out):
        self.out, self.template_path = out, None

    def get_output_path(self):
        return self.out


def test_algo_pickle_round_trip(tmp_path):
    algo = _Stub(str(tmp_path))
    pkl = port_utils.algo_to_pickle(algo, template_path=str(tmp_path), best_metric=0.5)
    back, meta = port_utils.algo_from_pickle(pkl)
    assert isinstance(back, _Stub) and back.out == algo.out and meta == {"best_metric": 0.5}
    assert back.template_path == str(tmp_path) and os.path.basename(pkl) == "algo_object.pkl"


def test_strenum_dumps_as_a_plain_string():
    report = {DataStatsKeys.SUMMARY: {ImageStatsKeys.SHAPE: [1, 2]}, "key": LabelStatsKeys.LABEL_UID}
    plain = {"stats_summary": {"shape": [1, 2]}, "key": "labels"}
    ref = {JaxDataStatsKeys.SUMMARY: {"shape": [1, 2]}, "key": "labels"}
    assert yaml.safe_dump(report) == yaml.safe_dump(plain) == yaml.safe_dump(ref)
    assert yaml.safe_load(yaml.safe_dump(report)) == plain
