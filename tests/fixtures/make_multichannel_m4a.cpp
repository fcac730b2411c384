// Writes tests/fixtures/tone_16ch.m4a: 0.3 s at 16 kHz, 16 channels
// (FFmpeg's "hexadecagonal" layout), channel c a 0.05-amplitude sine at
// 200 + 60 c Hz, AAC in an MP4 (ipod) container.  The AAC decoder returns
// planar float frames with 16 channel planes, more than AVFrame::data[]
// holds (8): the case the decoders' swr_convert call must read through
// extended_data.  mwx_encode_fixture writes mono only, hence this program.
//
//   g++ -O2 -o make_multichannel_m4a make_multichannel_m4a.cpp -lavformat -lavcodec -lavutil
//   ./make_multichannel_m4a tone_16ch.m4a

#include <cmath>
#include <cstdio>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
}

namespace {

int drain(AVCodecContext* enc, AVFormatContext* fmt, AVStream* st,
          AVPacket* pkt) {
    for (;;) {
        int rc = avcodec_receive_packet(enc, pkt);
        if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
        if (rc < 0) return rc;
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        if ((rc = av_interleaved_write_frame(fmt, pkt)) < 0) return rc;
    }
}

}  // namespace

int main(int argc, char** argv) {
    if (argc != 2) {
        fprintf(stderr, "usage: %s OUT.m4a\n", argv[0]);
        return 2;
    }
    const int sr = 16000;
    const int64_t n = sr * 3 / 10;
    AVFormatContext* fmt = nullptr;
    if (avformat_alloc_output_context2(&fmt, nullptr, "ipod", argv[1]) < 0)
        return 3;
    const AVCodec* codec = avcodec_find_encoder_by_name("aac");
    if (!codec) return 4;
    AVCodecContext* enc = avcodec_alloc_context3(codec);
    enc->sample_rate = sr;
    if (av_channel_layout_from_string(&enc->ch_layout, "hexadecagonal") < 0)
        return 5;
    const int ch = enc->ch_layout.nb_channels;
    enc->sample_fmt = AV_SAMPLE_FMT_FLTP;
    enc->bit_rate = 16000 * ch;
    enc->time_base = AVRational{1, sr};
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
        enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(enc, codec, nullptr) < 0) return 6;
    AVStream* st = avformat_new_stream(fmt, nullptr);
    avcodec_parameters_from_context(st->codecpar, enc);
    st->time_base = enc->time_base;
    if (avio_open(&fmt->pb, argv[1], AVIO_FLAG_WRITE) < 0) return 7;
    if (avformat_write_header(fmt, nullptr) < 0) return 8;
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    for (int64_t off = 0; off < n; off += enc->frame_size) {
        int k = static_cast<int>(n - off < enc->frame_size
                                 ? n - off : enc->frame_size);
        frame->nb_samples = k;
        frame->format = enc->sample_fmt;
        av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
        if (av_frame_get_buffer(frame, 0) < 0) return 9;
        for (int c = 0; c < ch; ++c) {
            float* plane = reinterpret_cast<float*>(frame->extended_data[c]);
            for (int i = 0; i < k; ++i)
                plane[i] = 0.05f * sinf(2.0f * static_cast<float>(M_PI)
                                        * (200.0f + 60.0f * c)
                                        * static_cast<float>(off + i) / sr);
        }
        frame->pts = off;
        if (avcodec_send_frame(enc, frame) < 0) return 10;
        av_frame_unref(frame);
        if (drain(enc, fmt, st, pkt) < 0) return 11;
    }
    avcodec_send_frame(enc, nullptr);
    if (drain(enc, fmt, st, pkt) < 0) return 11;
    av_write_trailer(fmt);
    avio_closep(&fmt->pb);
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avcodec_free_context(&enc);
    avformat_free_context(fmt);
    return 0;
}
