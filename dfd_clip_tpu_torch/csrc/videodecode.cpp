// The port's FFmpeg seek-decoder (its own copy of the JAX package's
// csrc/videodecode.cpp, which the port reads nothing of).
//
// The counterpart of TorchVision's `video_reader` C++ backend, which the
// upstream training code decodes through: given a list of target
// timestamps, returns for each the first frame with pts >= t (the
// `seek(t); next()` semantics), as packed RGB24 or planar YUV420.
// Sequential targets decode forward without re-seeking; backward jumps seek
// to the preceding keyframe. A host library, no CUDA kernel: the decode is
// host work, and the planar YUV output goes to the card, where
// ops/image_ops.py:yuv420_to_rgb converts it.
//
// Built with videoencode.cpp on first use by data/native_video.py (g++
// -O2 -fPIC -shared -std=c++17, -lavformat -lavcodec -lavutil -lswscale)
// into build/dfd_clip_tpu_torch/.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <cmath>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kEps = 1e-6;

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  int stream_index = -1;
  double time_base = 0.0;
  // current decode position: pts (seconds) of the last returned frame
  double last_pts = -1.0;
  bool eof = false;

  ~Decoder() {
    if (sws) sws_freeContext(sws);
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    stream_index =
        av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (stream_index < 0) return -3;
    AVStream* st = fmt->streams[stream_index];
    const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!dec) return -4;
    codec = avcodec_alloc_context3(dec);
    if (!codec) return -5;
    if (avcodec_parameters_to_context(codec, st->codecpar) < 0) return -6;
    codec->thread_count = 0;  // auto
    if (avcodec_open2(codec, dec, nullptr) < 0) return -7;
    time_base = av_q2d(st->time_base);
    return 0;
  }

  double fps() const {
    AVStream* st = fmt->streams[stream_index];
    AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
    return r.den ? av_q2d(r) : 0.0;
  }

  double duration() const {
    AVStream* st = fmt->streams[stream_index];
    if (st->duration > 0) return st->duration * time_base;
    if (fmt->duration > 0) return fmt->duration / (double)AV_TIME_BASE;
    return 0.0;
  }

  int64_t frames() const {
    AVStream* st = fmt->streams[stream_index];
    if (st->nb_frames > 0) return st->nb_frames;
    double f = fps();
    return f > 0 ? (int64_t)std::llround(duration() * f) : 0;
  }

  int seek(double t) {
    int64_t ts = (int64_t)std::floor(t / time_base);
    if (av_seek_frame(fmt, stream_index, ts, AVSEEK_FLAG_BACKWARD) < 0)
      return -1;
    avcodec_flush_buffers(codec);
    last_pts = -1.0;
    eof = false;
    return 0;
  }

  // Decode forward until a frame with pts >= t; frame left in `out`.
  // At EOF the most recent frame is returned instead (clamp-to-last, the
  // container-seek behavior of TorchVision near stream end).
  int decode_until(double t, AVFrame* out) {
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    bool have_any = false;
    bool flushed = false;
    int rc = -1;
    while (true) {
      int err = avcodec_receive_frame(codec, frame);
      if (err == 0) {
        int64_t raw = frame->best_effort_timestamp != AV_NOPTS_VALUE
                          ? frame->best_effort_timestamp
                          : frame->pts;
        double pts = raw == AV_NOPTS_VALUE ? last_pts + 1.0 / (fps() > 0 ? fps() : 25.0)
                                           : raw * time_base;
        last_pts = pts;
        // keep the most recent frame in `out` so EOF can clamp to it
        av_frame_unref(out);
        av_frame_move_ref(out, frame);
        have_any = true;
        if (pts >= t - kEps) {
          rc = 0;
          break;
        }
        continue;
      }
      if (err == AVERROR_EOF) {
        eof = true;
        if (have_any) rc = 0;
        break;
      }
      if (err != AVERROR(EAGAIN)) break;
      // feed more packets
      int perr;
      while ((perr = av_read_frame(fmt, pkt)) >= 0) {
        if (pkt->stream_index == stream_index) break;
        av_packet_unref(pkt);
      }
      if (perr < 0) {
        if (flushed) { if (have_any) rc = 0; break; }
        avcodec_send_packet(codec, nullptr);  // flush
        flushed = true;
      } else {
        avcodec_send_packet(codec, pkt);
        av_packet_unref(pkt);
      }
    }
    av_frame_free(&frame);
    av_packet_free(&pkt);
    return rc;
  }

  int to_rgb(AVFrame* frame, unsigned char* dst) {
    sws = sws_getCachedContext(sws, codec->width, codec->height, codec->pix_fmt,
                               codec->width, codec->height, AV_PIX_FMT_RGB24,
                               SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!sws) return -1;
    uint8_t* planes[1] = {dst};
    int strides[1] = {3 * codec->width};
    sws_scale(sws, frame->data, frame->linesize, 0, codec->height, planes,
              strides);
    return 0;
  }

  // Planar YUV420 output: a raw plane copy for the yuv420p/yuvj420p sources
  // the datasets use (no range conversion — the flag tells the device-side
  // converter which matrix to apply); swscale fallback for other formats.
  int to_yuv420(AVFrame* frame, unsigned char* y, unsigned char* u,
                unsigned char* v, int* full_range) {
    const int w = codec->width, h = codec->height;
    const AVPixelFormat fmt = (AVPixelFormat)frame->format;
    if (fmt == AV_PIX_FMT_YUV420P || fmt == AV_PIX_FMT_YUVJ420P) {
      *full_range = (fmt == AV_PIX_FMT_YUVJ420P ||
                     frame->color_range == AVCOL_RANGE_JPEG)
                        ? 1
                        : 0;
      for (int r = 0; r < h; ++r)
        std::memcpy(y + (size_t)r * w, frame->data[0] + (size_t)r * frame->linesize[0], w);
      for (int r = 0; r < h / 2; ++r) {
        std::memcpy(u + (size_t)r * (w / 2), frame->data[1] + (size_t)r * frame->linesize[1], w / 2);
        std::memcpy(v + (size_t)r * (w / 2), frame->data[2] + (size_t)r * frame->linesize[2], w / 2);
      }
      return 0;
    }
    *full_range = 0;
    sws = sws_getCachedContext(sws, w, h, fmt, w, h, AV_PIX_FMT_YUV420P,
                               SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!sws) return -1;
    uint8_t* planes[3] = {y, u, v};
    int strides[3] = {w, w / 2, w / 2};
    sws_scale(sws, frame->data, frame->linesize, 0, h, planes, strides);
    return 0;
  }
};

}  // namespace

extern "C" {

int dfd_probe(const char* path, double* fps, long* frames, double* duration) {
  Decoder d;
  int rc = d.open(path);
  if (rc != 0) return rc;
  *fps = d.fps();
  *frames = (long)d.frames();
  *duration = d.duration();
  return 0;
}

int dfd_frame_size(const char* path, int* height, int* width) {
  Decoder d;
  int rc = d.open(path);
  if (rc != 0) return rc;
  *height = d.codec->height;
  *width = d.codec->width;
  return 0;
}

// Decode the first frame with pts >= times[i] for each i into `out`
// (n * height * width * 3 RGB24). Monotonically increasing times decode
// forward without seeking; otherwise we seek to the prior keyframe.
int dfd_read_frames(const char* path, const double* times, int n,
                    unsigned char* out) {
  Decoder d;
  int rc = d.open(path);
  if (rc != 0) return rc;
  const int frame_bytes = d.codec->width * d.codec->height * 3;
  AVFrame* frame = av_frame_alloc();
  double total = d.duration();

  for (int i = 0; i < n; ++i) {
    double t = times[i];
    if (total > 0 && t > total + kEps) { av_frame_free(&frame); return -10; }
    // Seek when jumping backward, or far forward (>2s of decode work).
    if (d.last_pts < 0 || t < d.last_pts - kEps || t > d.last_pts + 2.0) {
      if (d.seek(t) != 0) { av_frame_free(&frame); return -11; }
    }
    if (d.last_pts >= t - kEps && i > 0) {
      // The previously returned frame is already the first with pts >= t
      // (targets are monotone between seeks); reuse it.
      std::memcpy(out + (size_t)i * frame_bytes,
                  out + (size_t)(i - 1) * frame_bytes, frame_bytes);
      continue;
    }
    if (d.decode_until(t, frame) != 0) { av_frame_free(&frame); return -12; }
    if (d.to_rgb(frame, out + (size_t)i * frame_bytes) != 0) {
      av_frame_free(&frame);
      return -13;
    }
    av_frame_unref(frame);
  }
  av_frame_free(&frame);
  return 0;
}

// YUV420-planar variant of dfd_read_frames: out_y is n*H*W, out_u/out_v are
// n*(H/2)*(W/2). Dimensions must be even. *full_range is set to 1 for
// JPEG/full-range sources (the device converter picks the matrix).
int dfd_read_frames_yuv(const char* path, const double* times, int n,
                        unsigned char* out_y, unsigned char* out_u,
                        unsigned char* out_v, int* full_range) {
  Decoder d;
  int rc = d.open(path);
  if (rc != 0) return rc;
  const int w = d.codec->width, h = d.codec->height;
  if (w % 2 || h % 2) return -14;
  const size_t ybytes = (size_t)w * h;
  const size_t cbytes = ybytes / 4;
  AVFrame* frame = av_frame_alloc();
  double total = d.duration();

  for (int i = 0; i < n; ++i) {
    double t = times[i];
    if (total > 0 && t > total + kEps) { av_frame_free(&frame); return -10; }
    if (d.last_pts < 0 || t < d.last_pts - kEps || t > d.last_pts + 2.0) {
      if (d.seek(t) != 0) { av_frame_free(&frame); return -11; }
    }
    if (d.last_pts >= t - kEps && i > 0) {
      std::memcpy(out_y + (size_t)i * ybytes, out_y + (size_t)(i - 1) * ybytes, ybytes);
      std::memcpy(out_u + (size_t)i * cbytes, out_u + (size_t)(i - 1) * cbytes, cbytes);
      std::memcpy(out_v + (size_t)i * cbytes, out_v + (size_t)(i - 1) * cbytes, cbytes);
      continue;
    }
    if (d.decode_until(t, frame) != 0) { av_frame_free(&frame); return -12; }
    if (d.to_yuv420(frame, out_y + (size_t)i * ybytes,
                    out_u + (size_t)i * cbytes,
                    out_v + (size_t)i * cbytes, full_range) != 0) {
      av_frame_free(&frame);
      return -13;
    }
    av_frame_unref(frame);
  }
  av_frame_free(&frame);
  return 0;
}

}  // extern "C"
