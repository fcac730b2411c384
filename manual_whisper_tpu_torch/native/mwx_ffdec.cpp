// mwx_ffdec of manual_whisper_tpu_torch: a copy of
// manual_whisper_tpu/native/mwx_ffdec.cpp (same C ABI, the >8-channel planar
// fix included), built best-effort by the port's audio/native.py.
//
// In-process compressed-audio frontend: demux + decode + downmix for the
// container formats the reference feeds through an ffmpeg SUBPROCESS
// (reference: transcribe.py:117 whisperx.load_audio; format list
// README.md:90 — m4a/mp3/ogg/aac/opus/webm/...).  The reference's canonical
// input is .m4a (transcribe.py:239); this shim links the system FFmpeg
// libraries (libavformat/libavcodec/libswresample) directly into the
// frontend, so those uploads decode natively in-process — no subprocess,
// no temp files, no ffmpeg CLI requirement.  Built best-effort: hosts
// without the FFmpeg dev libraries skip this object and keep the
// WAV/FLAC-only native frontend plus the actionable zh-CN error
// (audio/io.py UnsupportedFormatError).
//
// Exports (C ABI, ctypes-bound in audio/native.py):
//   mwx_decode_any(data, len, &out, &out_len, &sr) -> 0 on success; out is
//     malloc'd mono float32 at the stream's native rate (caller resamples
//     with the repo's polyphase for cross-path consistency), freed with
//     mwx_ffdec_free.
//   mwx_encode_fixture(pcm, n, sr, format, codec, &out, &out_len) -> test
//     fixture encoder (mp3/m4a/ogg) so round-trip tests and fuzz corpora
//     need no external encoder binary.
//   mwx_ffdec_free(ptr)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

struct MemReader {
    const uint8_t* data;
    int64_t size;
    int64_t pos;
};

int mem_read(void* opaque, uint8_t* buf, int buf_size) {
    MemReader* r = static_cast<MemReader*>(opaque);
    int64_t remain = r->size - r->pos;
    if (remain <= 0) return AVERROR_EOF;
    int n = static_cast<int>(remain < buf_size ? remain : buf_size);
    memcpy(buf, r->data + r->pos, n);
    r->pos += n;
    return n;
}

int64_t mem_seek(void* opaque, int64_t offset, int whence) {
    MemReader* r = static_cast<MemReader*>(opaque);
    if (whence == AVSEEK_SIZE) return r->size;
    whence &= ~AVSEEK_FORCE;
    int64_t base = whence == SEEK_CUR ? r->pos
                 : whence == SEEK_END ? r->size : 0;
    int64_t target = base + offset;
    if (target < 0 || target > r->size) return AVERROR(EINVAL);
    r->pos = target;
    return target;
}

// RAII-ish cleanup bundle so every early return frees everything once.
struct DecodeCtx {
    AVFormatContext* fmt = nullptr;
    AVIOContext* avio = nullptr;
    AVCodecContext* dec = nullptr;
    SwrContext* swr = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    // the input shape swr was initialized with (frames may diverge
    // mid-stream in Ogg/Matroska; swr must be rebuilt on mismatch)
    AVChannelLayout swr_in_layout{};
    int swr_in_fmt = AV_SAMPLE_FMT_NONE;
    int swr_in_rate = 0;
    ~DecodeCtx() {
        av_channel_layout_uninit(&swr_in_layout);
        if (pkt) av_packet_free(&pkt);
        if (frame) av_frame_free(&frame);
        if (swr) swr_free(&swr);
        if (dec) avcodec_free_context(&dec);
        if (fmt) avformat_close_input(&fmt);
        if (avio) {
            av_freep(&avio->buffer);
            avio_context_free(&avio);
        }
    }
};

int drain_frames(DecodeCtx& c, std::vector<float>& out) {
    // receive every pending frame, resampled to mono float32
    for (;;) {
        int rc = avcodec_receive_frame(c.dec, c.frame);
        if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
        if (rc < 0) return rc;
        // Mid-stream layout/format changes are legal in Ogg/Matroska;
        // feeding swr a frame shaped differently from its configured
        // input makes it read the wrong number of planes.  Rebuild swr
        // on mismatch (output stays mono f32 at the decoder rate).
        if (av_channel_layout_compare(&c.frame->ch_layout,
                                      &c.swr_in_layout) != 0
            || c.frame->format != c.swr_in_fmt
            || c.frame->sample_rate != c.swr_in_rate) {
            AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
            swr_free(&c.swr);
            if (swr_alloc_set_opts2(&c.swr, &mono, AV_SAMPLE_FMT_FLT,
                                    c.dec->sample_rate, &c.frame->ch_layout,
                                    static_cast<AVSampleFormat>(
                                        c.frame->format),
                                    c.frame->sample_rate, 0, nullptr) < 0
                || swr_init(c.swr) < 0)
                return AVERROR(EINVAL);
            if (av_channel_layout_copy(&c.swr_in_layout,
                                       &c.frame->ch_layout) < 0)
                return AVERROR(ENOMEM);
            c.swr_in_fmt = c.frame->format;
            c.swr_in_rate = c.frame->sample_rate;
        }
        int max_out = swr_get_out_samples(c.swr, c.frame->nb_samples);
        if (max_out < c.frame->nb_samples) max_out = c.frame->nb_samples + 256;
        size_t base = out.size();
        out.resize(base + max_out);
        uint8_t* dst = reinterpret_cast<uint8_t*>(out.data() + base);
        // extended_data, NOT data: for planar audio with >8 channels
        // (e.g. multichannel Opus, up to 255 ch) data[] holds only the
        // first 8 plane pointers — passing it lets swr read past the
        // array and dereference garbage (remote crash on untrusted
        // uploads).  extended_data aliases data for <=8 channels.
        int got = swr_convert(c.swr, &dst, max_out,
                              const_cast<const uint8_t**>(
                                  c.frame->extended_data),
                              c.frame->nb_samples);
        if (got < 0) return got;
        out.resize(base + got);
        av_frame_unref(c.frame);
    }
}

}  // namespace

extern "C" void mwx_ffdec_free(void* p) { free(p); }

extern "C" int mwx_decode_any(const uint8_t* data, uint64_t len,
                              float** out_samples, int64_t* out_len,
                              int32_t* out_sr) {
    if (!data || len == 0 || !out_samples || !out_len || !out_sr) return -1;
    av_log_set_level(AV_LOG_ERROR);   // codec-delay warnings are routine
    *out_samples = nullptr;
    *out_len = 0;
    *out_sr = 0;

    DecodeCtx c;
    MemReader reader{data, static_cast<int64_t>(len), 0};

    unsigned char* iobuf = static_cast<unsigned char*>(av_malloc(1 << 16));
    if (!iobuf) return -2;
    c.avio = avio_alloc_context(iobuf, 1 << 16, 0, &reader,
                                mem_read, nullptr, mem_seek);
    if (!c.avio) { av_free(iobuf); return -2; }

    c.fmt = avformat_alloc_context();
    if (!c.fmt) return -2;
    c.fmt->pb = c.avio;
    c.fmt->flags |= AVFMT_FLAG_CUSTOM_IO;
    if (avformat_open_input(&c.fmt, nullptr, nullptr, nullptr) < 0)
        return -3;                       // not a recognized container
    if (avformat_find_stream_info(c.fmt, nullptr) < 0) return -3;

    const AVCodec* codec = nullptr;
    int stream_idx = av_find_best_stream(c.fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                         &codec, 0);
    if (stream_idx < 0 || !codec) return -4;   // no decodable audio stream
    AVStream* stream = c.fmt->streams[stream_idx];

    c.dec = avcodec_alloc_context3(codec);
    if (!c.dec) return -2;
    if (avcodec_parameters_to_context(c.dec, stream->codecpar) < 0) return -5;
    if (avcodec_open2(c.dec, codec, nullptr) < 0) return -5;
    if (c.dec->sample_rate <= 0) return -5;
    if (c.dec->ch_layout.nb_channels <= 0)
        av_channel_layout_default(&c.dec->ch_layout, 1);

    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    if (swr_alloc_set_opts2(&c.swr, &mono, AV_SAMPLE_FMT_FLT,
                            c.dec->sample_rate, &c.dec->ch_layout,
                            c.dec->sample_fmt, c.dec->sample_rate,
                            0, nullptr) < 0 || swr_init(c.swr) < 0)
        return -6;
    if (av_channel_layout_copy(&c.swr_in_layout, &c.dec->ch_layout) < 0)
        return -2;
    c.swr_in_fmt = c.dec->sample_fmt;
    c.swr_in_rate = c.dec->sample_rate;

    c.pkt = av_packet_alloc();
    c.frame = av_frame_alloc();
    if (!c.pkt || !c.frame) return -2;

    std::vector<float> pcm;
    pcm.reserve(1 << 20);
    while (av_read_frame(c.fmt, c.pkt) >= 0) {
        if (c.pkt->stream_index == stream_idx) {
            // a corrupt packet may fail to send; skip it rather than abort
            // (ffmpeg CLI behaves the same under -err_detect default)
            if (avcodec_send_packet(c.dec, c.pkt) >= 0) {
                if (drain_frames(c, pcm) < 0) {
                    av_packet_unref(c.pkt);
                    return -7;
                }
            }
        }
        av_packet_unref(c.pkt);
    }
    avcodec_send_packet(c.dec, nullptr);   // flush the decoder
    if (drain_frames(c, pcm) < 0) return -7;
    // flush the resampler's tail
    for (;;) {
        float tail[4096];
        uint8_t* dst = reinterpret_cast<uint8_t*>(tail);
        int got = swr_convert(c.swr, &dst, 4096, nullptr, 0);
        if (got <= 0) break;
        pcm.insert(pcm.end(), tail, tail + got);
    }

    if (pcm.empty()) return -8;            // container held no audio frames
    float* out = static_cast<float*>(malloc(pcm.size() * sizeof(float)));
    if (!out) return -2;
    memcpy(out, pcm.data(), pcm.size() * sizeof(float));
    *out_samples = out;
    *out_len = static_cast<int64_t>(pcm.size());
    *out_sr = c.dec->sample_rate;
    return 0;
}

// ---------------------------------------------------------------------------
// Fixture encoder (tests/fuzz corpora only — NOT a product path)
// ---------------------------------------------------------------------------

namespace {

struct EncodeCtx {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* enc = nullptr;
    SwrContext* swr = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    ~EncodeCtx() {
        if (pkt) av_packet_free(&pkt);
        if (frame) av_frame_free(&frame);
        if (swr) swr_free(&swr);
        if (enc) avcodec_free_context(&enc);
        if (fmt) {
            if (fmt->pb) {
                uint8_t* buf = nullptr;
                avio_close_dyn_buf(fmt->pb, &buf);
                av_free(buf);
                fmt->pb = nullptr;
            }
            avformat_free_context(fmt);
        }
    }
};

int write_encoded(EncodeCtx& c, AVStream* stream) {
    for (;;) {
        int rc = avcodec_receive_packet(c.enc, c.pkt);
        if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
        if (rc < 0) return rc;
        av_packet_rescale_ts(c.pkt, c.enc->time_base, stream->time_base);
        c.pkt->stream_index = stream->index;
        rc = av_interleaved_write_frame(c.fmt, c.pkt);
        if (rc < 0) return rc;
    }
}

}  // namespace

extern "C" int mwx_encode_fixture(const float* pcm, int64_t n, int32_t sr,
                                  const char* format_name,
                                  const char* codec_name,
                                  uint8_t** out_data, uint64_t* out_len) {
    if (!pcm || n <= 0 || !format_name || !out_data || !out_len) return -1;
    *out_data = nullptr;
    *out_len = 0;

    EncodeCtx c;
    if (avformat_alloc_output_context2(&c.fmt, nullptr, format_name,
                                       nullptr) < 0 || !c.fmt)
        return -2;
    const AVCodec* codec = codec_name && codec_name[0]
        ? avcodec_find_encoder_by_name(codec_name)
        : avcodec_find_encoder(c.fmt->oformat->audio_codec);
    if (!codec) return -3;

    c.enc = avcodec_alloc_context3(codec);
    if (!c.enc) return -2;
    c.enc->sample_rate = sr;
    av_channel_layout_default(&c.enc->ch_layout, 1);
    c.enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0]
                                           : AV_SAMPLE_FMT_FLTP;
    c.enc->bit_rate = 96000;
    c.enc->time_base = AVRational{1, sr};
    if (c.fmt->oformat->flags & AVFMT_GLOBALHEADER)
        c.enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(c.enc, codec, nullptr) < 0) return -4;

    AVStream* stream = avformat_new_stream(c.fmt, nullptr);
    if (!stream) return -2;
    if (avcodec_parameters_from_context(stream->codecpar, c.enc) < 0)
        return -2;
    stream->time_base = c.enc->time_base;

    if (avio_open_dyn_buf(&c.fmt->pb) < 0) return -2;
    if (avformat_write_header(c.fmt, nullptr) < 0) return -5;

    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    if (swr_alloc_set_opts2(&c.swr, &c.enc->ch_layout, c.enc->sample_fmt, sr,
                            &mono, AV_SAMPLE_FMT_FLT, sr, 0, nullptr) < 0
        || swr_init(c.swr) < 0)
        return -6;

    c.pkt = av_packet_alloc();
    c.frame = av_frame_alloc();
    if (!c.pkt || !c.frame) return -2;
    int frame_size = c.enc->frame_size > 0 ? c.enc->frame_size : 1024;
    int64_t pts = 0;
    for (int64_t off = 0; off < n; off += frame_size) {
        int chunk = static_cast<int>(n - off < frame_size ? n - off
                                                          : frame_size);
        c.frame->nb_samples = chunk;
        c.frame->format = c.enc->sample_fmt;
        if (av_channel_layout_copy(&c.frame->ch_layout,
                                   &c.enc->ch_layout) < 0) return -2;
        if (av_frame_get_buffer(c.frame, 0) < 0) return -2;
        const uint8_t* src = reinterpret_cast<const uint8_t*>(pcm + off);
        if (swr_convert(c.swr, c.frame->data, chunk, &src, chunk) < 0)
            return -6;
        c.frame->pts = pts;
        pts += chunk;
        if (avcodec_send_frame(c.enc, c.frame) < 0) return -7;
        av_frame_unref(c.frame);
        if (write_encoded(c, stream) < 0) return -7;
    }
    avcodec_send_frame(c.enc, nullptr);    // flush
    if (write_encoded(c, stream) < 0) return -7;
    if (av_write_trailer(c.fmt) < 0) return -5;

    uint8_t* buf = nullptr;
    int size = avio_close_dyn_buf(c.fmt->pb, &buf);
    c.fmt->pb = nullptr;
    if (size < 0 || !buf) return -2;
    uint8_t* out = static_cast<uint8_t*>(malloc(size));
    if (!out) { av_free(buf); return -2; }
    memcpy(out, buf, size);
    av_free(buf);
    *out_data = out;
    *out_len = static_cast<uint64_t>(size);
    return 0;
}
