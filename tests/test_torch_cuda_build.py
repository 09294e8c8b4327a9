"""The kernel build's bookkeeping, as far as a machine without nvcc can
check it: the library's name is keyed by every ``.cu`` source AND every
``.cuh`` header (an edited header must never load a stale library), the
ten kernels are registered with their C symbols, each source defines the
symbols it is registered under, and no launcher takes a host tensor.
A source without an entry point of its own (the tensor-core kernels of
the stripe, plain and typed window attention) must be reached from the
source that holds the entry points, and the one kernel template of the
tensor-core route from both sources that instantiate it."""
import re
import shutil

import pytest
import torch

from hmvit_tpu_torch.ops import cuda

KERNELS = {
    "pair_warp": ("hm_pair_warp", "pair_warp.cu"),
    "pair_warp_resident": ("hm_pair_warp_resident", "pair_warp.cu"),
    "stripe_window_attention": ("hm_stripe_window_attention",
                                "window_attention.cu"),
    "plain_window_attention": ("hm_plain_window_attention",
                               "window_attention.cu"),
    "typed_window_attention": ("hm_typed_window_attention",
                               "window_attention.cu"),
    "warp_window_attention": ("hm_warp_window_attention",
                              "fused_warp_attention.cu"),
    "segmented_max_scan": ("hm_segmented_max_scan", "segscan.cu"),
    "expand_rows": ("hm_expand_rows", "expand.cu"),
    "expand_rows_v2": ("hm_expand_rows_v2", "expand.cu"),
    "ms_deform_attn": ("hm_ms_deform_attn", "ms_deform_attn.cu"),
}

# sources launched through another source's C entry points: source ->
# (the source with the entry points, the host function it calls)
INNER_SOURCES = {"window_attention_mma.cu": (
    "window_attention.cu", "hm::launch_window_attention_mma(")}
# C entry points beside the registered ones: the previous body for
# timing (the attention kernels' fp32 CUDA-core body, the pair warp's and
# the segmented scan's one thread per 8 channels), the count of launches
# by body, and the scan's tiling (mirrored by ``segscan.scan_plan``)
EXTRA_SYMBOLS = {"hm_pair_warp_previous": "pair_warp.cu",
                 "hm_segmented_max_scan_previous": "segscan.cu",
                 "hm_segmented_max_scan_plan": "segscan.cu",
                 "hm_stripe_window_attention_simt": "window_attention.cu",
                 "hm_warp_window_attention_simt": "fused_warp_attention.cu",
                 "hm_plain_window_attention_simt": "window_attention.cu",
                 "hm_typed_window_attention_simt": "window_attention.cu",
                 "hm_attention_body_rule": "window_attention.cu",
                 "hm_attention_body_launches": "window_attention.cu",
                 "hm_attention_body_reset": "window_attention.cu"}


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A scratch copy of csrc/ that ``cuda`` reads instead of the real
    one."""
    copy = tmp_path / "csrc"
    shutil.copytree(cuda.CSRC_DIR, copy)
    monkeypatch.setattr(cuda, "CSRC_DIR", copy)
    return copy


@pytest.mark.parametrize("pattern", ["*.cu", "*.cuh"])
def test_library_name_follows_every_source_and_header(csrc_copy, pattern):
    before = cuda.library_path()
    assert cuda.library_path() == before  # a pure function of the files
    for path in sorted(csrc_copy.glob(pattern)):
        with open(path, "a") as f:
            f.write("\n// edited\n")
        after = cuda.library_path()
        assert after != before, path.name
        before = after
    assert before.parent == cuda.BUILD_DIR


def test_headers_are_shared_not_copied(csrc_copy):
    """The tap routine and the attention body live in one header each,
    included by every kernel that uses them."""
    text = {p.name: p.read_text() for p in csrc_copy.iterdir()}
    assert '#include "warp_taps.cuh"' in text["pair_warp.cu"]
    assert '#include "warp_taps.cuh"' in text["fused_warp_attention.cu"]
    assert '#include "attention_body.cuh"' in text["window_attention.cu"]
    assert '#include "attention_body.cuh"' in text["fused_warp_attention.cu"]
    for name, body in text.items():
        defines = ("WarpTaps plan_taps(" in body, "void attend_head(" in body)
        assert defines == (name == "warp_taps.cuh",
                           name == "attention_body.cuh"), name


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_registered_with_its_symbol_and_source(name):
    symbol, source = KERNELS[name]
    kernel = cuda.KERNELS[name]
    assert kernel.symbol == symbol
    text = (cuda.CSRC_DIR / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*{", text,
                  re.S)
    assert m, f"{source} does not define {symbol}"
    params = [p.strip() for p in m.group(1).split(",")]
    ptrs = [p for p in params if "*" in p]
    ints = [p for p in params if p.startswith("int ")]
    # the pointers, then the ints, then the stream: the launcher's order
    assert params == ptrs[:-1] + ints + ptrs[-1:]
    assert len(kernel.argtypes) == len(params)
    assert params[-1] == "void* stream"


def test_registry_is_exactly_the_ten_kernels():
    assert sorted(cuda.KERNELS) == sorted(KERNELS) and len(KERNELS) == 10
    assert {src for _, src in KERNELS.values()} | set(INNER_SOURCES) == {
        p.name for p in cuda.CSRC_DIR.glob("*.cu")}
    cuda.reset_launches()
    assert set(cuda.launch_counts().values()) == {0}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_no_launcher_takes_a_host_tensor(name):
    before = cuda.launch_counts()
    with pytest.raises(ValueError):
        cuda.KERNELS[name].launch([torch.zeros(4, 8)], [])
    assert cuda.launch_counts() == before


@pytest.mark.parametrize("source", sorted(INNER_SOURCES))
def test_inner_source_is_reached_from_the_entry_points(source):
    outer, call = INNER_SOURCES[source]
    inner_text = (cuda.CSRC_DIR / source).read_text()
    assert 'extern "C"' not in inner_text
    assert "int " + call.split("::")[-1] in inner_text
    outer_text = (cuda.CSRC_DIR / outer).read_text()
    # the stripe, the plain and the typed entry
    assert outer_text.count(call) == 3


def test_tensor_core_kernel_template_is_shared_not_copied():
    """One kernel template (``window_attention_mma_kernel.cuh``) for the
    three sources of a unit's rows: split and stripe windows are
    instantiated beside the window-attention entry points' inner source,
    the warped rows beside the fused kernel's entry points, which stage
    them with the pair warp's own tap routine."""
    text = {p.name: p.read_text() for p in cuda.CSRC_DIR.iterdir()}
    header = "window_attention_mma_kernel.cuh"
    includers = {name for name, body in text.items()
                 if f'#include "{header}"' in body}
    assert includers == {"window_attention_mma.cu", "fused_warp_attention.cu"}
    assert [name for name, body in text.items()
            if "window_attention_mma_kernel(const bf16* __restrict__ q,"
            in body] == [header]
    assert '#include "warp_taps.cuh"' in text[header]
    assert "warp_vec16<bf16>(plan," in text[header]
    assert "uint4 warp_vec16(" in text["warp_taps.cuh"]
    # the same routine, with the same ROI tile test, in both pair warps
    assert "hm::combine_taps<T>(" in text["pair_warp.cu"]
    assert "hm::warp_vec16<T>(" in text["pair_warp.cu"]
    for name in ("pair_warp.cu", header, "fused_warp_attention.cu"):
        assert "tile_in_view(" in text[name], name
    inner = text["window_attention_mma.cu"]
    fused = text["fused_warp_attention.cu"]
    assert "mma::kStripe>(" in inner and "mma::kSplit>(" in inner
    assert "kWarp" not in inner
    assert "hm::mma::kWarp>(" in fused and "kStripe" not in fused


@pytest.mark.parametrize("symbol", sorted(EXTRA_SYMBOLS))
def test_extra_entry_points_are_defined(symbol):
    text = (cuda.CSRC_DIR / EXTRA_SYMBOLS[symbol]).read_text()
    assert re.search(r'extern "C" (int|void) ' + symbol + r"\(", text)
    if symbol.endswith("_simt"):
        # same arguments as the entry point that chooses a body
        kernels = {k.symbol: k for k in cuda.SIMT_KERNELS}
        chooser = {k.symbol: k for k in cuda.KERNELS.values()}[symbol[:-5]]
        assert kernels[symbol].argtypes == chooser.argtypes
    if symbol == "hm_pair_warp_previous":
        assert cuda.PAIR_WARP_PREVIOUS.symbol == symbol
        assert cuda.PAIR_WARP_PREVIOUS.argtypes == cuda.PAIR_WARP.argtypes
    if symbol == "hm_segmented_max_scan_previous":
        assert cuda.SEGMENTED_MAX_SCAN_PREVIOUS.symbol == symbol
        assert (cuda.SEGMENTED_MAX_SCAN_PREVIOUS.argtypes
                == cuda.SEGMENTED_MAX_SCAN.argtypes)
