// Native video encoder: x264 (CRF) / mpeg4 writing via libavformat (the
// port's own copy of the JAX package's csrc/videoencode.cpp).
//
// Gives the preprocessing tools real x264 compression (the c23/c40
// re-encode of preprocessing/compression.py) without the ffmpeg binary,
// and lets tests synthesize h264 content for the decode path. Built into
// one library with videodecode.cpp (data/native_video.py).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstdio>
#include <cstring>
#include <string>

namespace {

struct Encoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  AVStream* stream = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  int64_t pts = 0;

  ~Encoder() {
    if (frame) av_frame_free(&frame);
    if (sws) sws_freeContext(sws);
    if (codec) avcodec_free_context(&codec);
    if (fmt) {
      if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
        avio_closep(&fmt->pb);
      avformat_free_context(fmt);
    }
  }

  int open(const char* path, const char* codec_name, int w, int h,
           double fps, int crf) {
    if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0)
      return -1;
    const AVCodec* enc = avcodec_find_encoder_by_name(codec_name);
    if (!enc) return -2;
    stream = avformat_new_stream(fmt, enc);
    if (!stream) return -3;
    codec = avcodec_alloc_context3(enc);
    codec->width = w;
    codec->height = h;
    codec->pix_fmt = AV_PIX_FMT_YUV420P;
    codec->time_base = av_d2q(1.0 / fps, 100000);
    stream->time_base = codec->time_base;
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
      codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (std::string(codec_name) == "libx264") {
      char buf[16];
      snprintf(buf, sizeof(buf), "%d", crf);
      av_opt_set(codec->priv_data, "crf", buf, 0);
      av_opt_set(codec->priv_data, "preset", "fast", 0);
    }
    if (avcodec_open2(codec, enc, nullptr) < 0) return -4;
    if (avcodec_parameters_from_context(stream->codecpar, codec) < 0) return -5;
    if (!(fmt->oformat->flags & AVFMT_NOFILE)) {
      if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -6;
    }
    if (avformat_write_header(fmt, nullptr) < 0) return -7;
    frame = av_frame_alloc();
    frame->format = codec->pix_fmt;
    frame->width = w;
    frame->height = h;
    if (av_frame_get_buffer(frame, 0) < 0) return -8;
    sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                         SWS_BILINEAR, nullptr, nullptr, nullptr);
    return sws ? 0 : -9;
  }

  int drain(AVPacket* pkt) {
    int err;
    while ((err = avcodec_receive_packet(codec, pkt)) == 0) {
      av_packet_rescale_ts(pkt, codec->time_base, stream->time_base);
      pkt->stream_index = stream->index;
      if (av_interleaved_write_frame(fmt, pkt) < 0) return -1;
    }
    return (err == AVERROR(EAGAIN) || err == AVERROR_EOF) ? 0 : -2;
  }

  int write_rgb(const unsigned char* rgb) {
    if (av_frame_make_writable(frame) < 0) return -1;
    const uint8_t* src[1] = {rgb};
    int stride[1] = {3 * codec->width};
    sws_scale(sws, src, stride, 0, codec->height, frame->data, frame->linesize);
    frame->pts = pts++;
    if (avcodec_send_frame(codec, frame) < 0) return -2;
    AVPacket* pkt = av_packet_alloc();
    int rc = drain(pkt);
    av_packet_free(&pkt);
    return rc;
  }

  int finish() {
    avcodec_send_frame(codec, nullptr);
    AVPacket* pkt = av_packet_alloc();
    int rc = drain(pkt);
    av_packet_free(&pkt);
    if (av_write_trailer(fmt) < 0) return -3;
    return rc;
  }
};

}  // namespace

extern "C" {

// Encode n RGB24 frames (n*h*w*3 contiguous) to `path`.
// codec: "libx264" (crf honored) or "mpeg4".
int dfd_encode_video(const char* path, const unsigned char* frames, int n,
                     int h, int w, double fps, int crf, const char* codec) {
  Encoder e;
  int rc = e.open(path, codec, w, h, fps, crf);
  if (rc != 0) return rc;
  const size_t frame_bytes = (size_t)h * w * 3;
  for (int i = 0; i < n; ++i) {
    rc = e.write_rgb(frames + (size_t)i * frame_bytes);
    if (rc != 0) return -20 + rc;
  }
  return e.finish();
}

}  // extern "C"
