"""PyTorch port: the kernel-variant timer's sources, on the CPU.

``kernel_variants`` builds its probes from copies of ``csrc/*.cu`` with one
part replaced; a replacement whose text is no longer in the source, or
stands there more than once, would only show on the card.  So each
variant's patches are applied here, and ptxas's parser is checked on
canned text.  Nothing is built.
"""

import re

import pytest

from manual_whisper_tpu_torch import kernel_variants as kv
from manual_whisper_tpu_torch.ops import _build

CASES = [(name, var) for name, spec in kv.VARIANTS.items()
         for var in spec[3]]


@pytest.mark.parametrize("name,var", CASES)
def test_variant_patches_apply(name, var):
    src, _, _, variants = kv.VARIANTS[name]
    text = (_build.CSRC_DIR / src).read_text()
    _, body, patches = variants[var]
    for old, new in patches:
        assert text.count(old) == 1, f"{var}: {old!r} not once in {src}"
        text = text.replace(old, new)
    if "stamps_" in var:
        assert all(f"MWX_STAMP({i});" in text for i in range(6))
    assert body.startswith(("return", "const int stripes"))


def test_every_kernel_has_a_runner_and_the_shipped_shape():
    assert set(kv.VARIANTS) == {"decode_self_attention", "int8_matmul",
                                "mel", "decode_cross_attention_int8"}
    for name, spec in kv.VARIANTS.items():
        assert any(not v.startswith(("probe", "stamps")) for v in spec[3])


def test_ptxas_parser_keeps_the_variant_kernels():
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_113matvec_kernelILi128ELi2EEEvPK13__nv_bfloat16' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 95 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z10tile_kernelv' for "
        "'sm_90a'\n"
        "ptxas info    : Used 168 registers\n")
    out = kv._ptxas(log)
    assert out == [
        "matvec_kernel<Li128ELi2>: 0 bytes stack frame, 0 bytes spill "
        "stores, 0 bytes spill loads",
        "matvec_kernel<Li128ELi2>: ptxas info    : Used 95 registers, used "
        "1 barriers"]


def test_mel_variants_name_the_shipped_shape_and_its_packing():
    """The mel entry's shipped variant is the kernel's ShippedMel, and each
    variant, like the shipped entry, reports the tile of the shape it
    launches: its constants are packed for that tile."""
    text = (_build.CSRC_DIR / "mel.cu").read_text()
    assert f"using ShippedMel = MelCfg<{kv._MEL_SHIPPED}>;" in text
    assert "return report_tile<ShippedMel>(tile);" in text
    variants = kv.VARIANTS["mel"][3]
    assert kv._mel_name(kv._MEL_SHIPPED) in variants
    for var in variants:
        src = kv.variant_source("mel", var)
        assert src.count("using VariantMel = MelCfg<") == 1
        assert "return launch_mel<VariantMel>(" in src
        assert src.endswith('extern "C" int mwx_variant_tile(void* tile) {\n'
                            "  return report_tile<VariantMel>(tile);\n}\n")


def _self_shapes(elem: str) -> dict:
    """{"Narrow": (split, keys, threads), "Wide": ...} of K3's
    ``SelfShape<elem>`` in decode_attention.cu."""
    text = (_build.CSRC_DIR / "decode_attention.cu").read_text()
    body = re.search(r"struct SelfShape<%s> \{(.*?)\};" % elem, text,
                     re.S).group(1)
    return {name: tuple(int(x) for x in args.split(", ")[:3])
            for name, args in re.findall(
                r"using (\w+) = SplitCfg<([^>]*), true>;", body)}


@pytest.mark.parametrize("dtype,elem,prefix", [("float32", "float", "f32_"),
                                               ("bfloat16", "bf16", "")])
def test_self_variants_of_each_dtype_hold_its_shipped_shapes(dtype, elem,
                                                             prefix):
    """``--dtype float32`` builds the f32_ variants (K3's float instance)
    and the empty-launch probes, the default the others; each set holds
    the shapes the kernel ships for its element type, and every f32_
    variant instantiates the float kernel."""
    chosen = kv.selected("decode_self_attention", dtype)
    assert all(v.startswith(prefix) or v.startswith("probe_empty")
               for v in chosen)
    assert {f"probe_empty_split{s}" for s in (1, 2, 4, 8)} <= set(chosen)
    shapes = _self_shapes(elem)
    assert set(shapes) == {"Narrow", "Wide"}
    for split, keys, threads in shapes.values():
        assert (f"{prefix}split{split}_keys{keys}_threads{threads}_push"
                in chosen)
    for var in chosen:
        if var.startswith("f32_"):
            src = kv.variant_source("decode_self_attention", var)
            assert re.search(r"launch_split<64, SplitCfg<\d+, \d+, \d+, "
                             r"true>, float>\(", src), var
    assert kv.selected("decode_self_attention", dtype,
                       only=["probe_empty_split8"]) == ["probe_empty_split8"]


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_int8_variants_hold_each_shipped_shape(split):
    """K5 ships ``Int8Shape<split>`` (``Int8Cfg<split, stages, keys,
    threads>``) for every split ``int8_split`` picks; each is among the
    timed variants, and each variant's source instantiates its own shape
    and launches through the shipped ``launch_int8``."""
    text = (_build.CSRC_DIR / "decode_attention.cu").read_text()
    found = re.search(r"using Int8Shape = Int8Cfg<SPLIT, (\d+), (\d+), "
                      r"(\d+)>;", text)
    stages, keys, threads = found.groups()
    assert re.search(rf"case {split}: return launch_int8<DH, S, "
                     rf"Int8Shape<{split}>>", text) or split == 1
    name = f"split{split}_stages{stages}_keys{keys}_threads{threads}"
    assert name in kv.VARIANTS["decode_cross_attention_int8"][3]
    src = kv.variant_source("decode_cross_attention_int8", name)
    assert (f"using VariantInt8 = Int8Cfg<{split}, {stages}, {keys}, "
            f"{threads}>;") in src
    assert "launch_int8<64, float, VariantInt8>(" in src
