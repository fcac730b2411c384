"""PyTorch port: the web-path post-processor against the JAX package's.

``post_process_segments`` of the port must return the JAX function's
output exactly (segments, ``stats``, ``quality_report``) on the cases of
``tests/test_text_processor.py`` and on generated segment lists: CJK and
Latin text, loops, prompt leaks and hallucination fragments, speakers,
NaN, infinite, negative and reversed times, missing keys.
"""

import json
import math

from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
import pytest

from manual_whisper_tpu.text import PostProcessOptions as JOptions
from manual_whisper_tpu.text import post_process_segments as j_post
from manual_whisper_tpu.text.formatting import format_to_markdown as j_md
from manual_whisper_tpu_torch.text import (PostProcessOptions,
                                           format_to_markdown,
                                           post_process_segments)


def seg(text, start=0.0, end=1.0, **kw):
    return {"text": text, "start": start, "end": end, **kw}


CASES = {
    "prompt-only": ([seg("请使用简体中文。"), seg("术语参考：微信、支付宝")], {}),
    "hallucination": ([seg("请不吝点赞 订阅 转发 打赏支持明镜与点点栏目", 0, 8),
                       seg("正常发言内容在这里", 8, 12)], {}),
    "spam-fragment": ([seg("今天讨论预算。点赞 订阅 转发 打赏支持大家", 0, 5)], {}),
    "noise-fillers": ([seg("嗯", 0, 0.5), seg("啊。", 1, 1.8), seg("嗯", 2, 8),
                       seg("好的收到", 9, 10)], {}),
    "short-single-char": ([seg("哇", 0, 0.2)], {}),
    "merge-speakers": ([seg("第一句", 0, 2, speaker="SPEAKER_00"),
                        seg("第二句", 2.3, 4, speaker="SPEAKER_00"),
                        seg("第三句", 5.5, 6, speaker="SPEAKER_00"),
                        seg("别人说", 6.1, 7, speaker="SPEAKER_01")], {}),
    "merge-no-speaker": ([seg("甲", 0, 1), seg("乙", 1.2, 2)], {}),
    "quality-report": ([seg("正常内容一", 0, 10),
                        seg("请使用简体中文。", 10, 30)], {}),
    "suspicious-merge": ([seg("请使用简体中文", 0, 6), seg("请用简体中文", 7, 13),
                          seg("实际内容", 14, 15)], {}),
    "latin": ([seg("hello world", 0, 1)], {}),
    "options-off": ([seg("请使用简体中文。附加", 0, 1), seg("嗯", 2, 2.5)],
                    dict(strip_prompt_leak=False, drop_short_noise=False,
                         merge_adjacent_segments=False)),
    "loops-and-terms": ([seg("文艺标识文艺标识文艺标识文艺标识好", 0, 3),
                         seg("AAP里面的搜码二维码！！！", 3, 6)], {}),
    "bad-times": ([seg("第一", float("nan"), 1), seg("第二", -3, -1),
                   seg("第三", 5, 2), {"text": "没有时间"}], {}),
}


def _canon(out) -> str:
    return json.dumps(out, ensure_ascii=False, sort_keys=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases_match_jax(name):
    segments, kw = CASES[name]
    ours = post_process_segments([dict(s) for s in segments],
                                 PostProcessOptions(**kw))
    theirs = j_post([dict(s) for s in segments], JOptions(**kw))
    assert _canon(ours) == _canon(theirs)
    assert format_to_markdown(ours["segments"]) == j_md(theirs["segments"])


def test_defaults_and_env_resolution_match_jax(monkeypatch):
    monkeypatch.setenv("TERM_REPLACEMENTS", "自定义=替换后;坏")
    monkeypatch.setenv("TERM_REPLACEMENTS_JSON", '{"甲方": "乙方", "x": 1}')
    monkeypatch.setenv("MAX_MERGE_GAP_SEC", "0.1")
    monkeypatch.setenv("DROP_SHORT_NOISE", "off")
    ours, theirs = PostProcessOptions.from_env(), JOptions.from_env()
    assert vars(ours) == vars(theirs)
    assert ours.term_replacements["自定义"] == "替换后"
    segments = [seg("甲方自定义", 0, 1), seg("嗯", 1.05, 1.2)]
    assert _canon(post_process_segments(segments)) == _canon(j_post(segments))


_TEXT_PIECES = ["大家好", "今天开会", "嗯", "啊。", "好的", "预算", "hello",
                "world", "请使用简体中文。", "术语参考：微信、支付宝",
                "中文会议讨论记录：", "点赞 订阅 转发 打赏支持", "明镜与点点栏目",
                "文艺标识", "AAP", "！！", "，，", " ", "。", "哈哈哈哈哈哈哈哈"]
_times = st.one_of(
    st.floats(min_value=-5, max_value=120, allow_nan=False),
    st.sampled_from([float("nan"), float("inf"), -float("inf"), 0.0]),
    st.integers(min_value=-2, max_value=60))


@st.composite
def _segments(draw):
    out = []
    for _ in range(draw(st.integers(0, 10))):
        text = "".join(draw(st.lists(st.sampled_from(_TEXT_PIECES),
                                     min_size=0, max_size=4)))
        if draw(st.booleans()):
            text = text * draw(st.integers(1, 5))      # loops
        s = {"text": text, "start": draw(_times), "end": draw(_times)}
        if draw(st.booleans()):
            s["speaker"] = draw(st.sampled_from(["SPEAKER_00",
                                                 "SPEAKER_01"]))
        if draw(st.integers(0, 9)) == 0:
            del s[draw(st.sampled_from(["start", "end"]))]
        out.append(s)
    return out


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(segments=_segments(), merge=st.booleans(), noise=st.booleans())
def test_generated_segments_match_jax(segments, merge, noise):
    kw = dict(merge_adjacent_segments=merge, drop_short_noise=noise)
    ours = post_process_segments([dict(s) for s in segments],
                                 PostProcessOptions(**kw))
    theirs = j_post([dict(s) for s in segments], JOptions(**kw))
    assert _canon(ours) == _canon(theirs)
    for s in ours["segments"]:
        assert math.isfinite(s["start"]) and math.isfinite(s["end"])
