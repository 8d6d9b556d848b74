"""HTTP front-end over the microbatching server (stdlib-only).

Counterpart of wavenet_tpu/serving/http.py, with no import of either
package's model code: a ThreadingHTTPServer where every connection thread
submits into the SAME engine, so concurrent HTTP requests are what feeds
the microbatcher its batches.

Endpoints:
  GET  /healthz       -> {"ok": true}
  GET  /info          -> config + engine stats JSON
  POST /synthesize    -> audio.  JSON body:
       {"seconds": 1.0 | "num_samples": 16000, "seed": 0,
        "temperature": 1.0, "speaker": 3, "stream": false,
        "prime": [...] | "prime_b64": "<base64 little-endian f32>"}
       prime: a float waveform in [-1, 1] to continue from.
       mel: [frames, M] log-mel frames (nested lists, or "mel_b64" with
       frames * M little-endian float32) for a mel-conditioned model;
       required there, answered with 400 elsewhere.
       speaker: the class id of a speaker-conditioned model, in
       [0, global_classes) (speaker 0 when omitted); 400 elsewhere or out
       of range.
       stream=false: complete 16-bit PCM WAV (Content-Type audio/wav).
       stream=true:  chunked raw int16 PCM (audio/L16; headers carry
       X-Sample-Rate / X-Num-Samples) — bytes flush as the model decodes,
       time-to-first-byte is one engine chunk, not the whole utterance.
"""

from __future__ import annotations

import base64
import io
import json
import wave as wave_mod

import numpy as np


def _opt_int(v):
    return None if v is None else int(v)


def _decode_f32(req: dict, key: str, cols=None):
    """Pull an optional float32 array from a JSON request: `key` as a
    (nested) list, or `key`_b64 as base64-packed little-endian float32 —
    rows of `cols` values when given (the compact wire form for mel).
    Returns None when absent; raises ValueError on malformed input."""
    v = req.get(key)
    b64 = req.get(f"{key}_b64")
    if v is not None and b64 is not None:
        raise ValueError(f"pass either {key} or {key}_b64, not both")
    if v is not None:
        arr = np.asarray(v, np.float32)
    elif b64 is not None:
        try:
            raw = base64.b64decode(b64, validate=True)
        except Exception as e:
            raise ValueError(f"{key}_b64 is not valid base64: {e}")
        if len(raw) % 4:
            raise ValueError(f"{key}_b64 length {len(raw)} is not a "
                             f"multiple of 4 (little-endian float32)")
        arr = np.frombuffer(raw, "<f4").astype(np.float32)
    else:
        return None
    if cols is not None:
        if arr.ndim == 1:
            if arr.size % cols:
                raise ValueError(
                    f"{key} has {arr.size} values, not divisible by the "
                    f"model's {cols} mel bins")
            arr = arr.reshape(-1, cols)
        elif arr.ndim != 2 or arr.shape[1] != cols:
            raise ValueError(f"{key} must be [frames, {cols}], got "
                             f"{arr.shape}")
    return arr


def _pcm16(x: np.ndarray) -> bytes:
    return (np.clip(np.asarray(x, np.float32), -1.0, 1.0)
            * 32767.0).astype("<i2").tobytes()


def _wav_bytes(x: np.ndarray, rate: int) -> bytes:
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(_pcm16(x))
    return buf.getvalue()


def make_server(engine, host: str = "127.0.0.1", port: int = 8000):
    """Build (not start) a ThreadingHTTPServer bound to `engine`
    (a WaveNetServer).  Call .serve_forever() / .shutdown() on the result;
    the bound port is server.server_address[1] (use port=0 for ephemeral).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    cfg = engine.cfg

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet by default; stats via /info
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/info":
                self._json(200, {
                    "sample_rate": cfg.sample_rate,
                    "quantization_channels": cfg.quantization_channels,
                    "receptive_field": cfg.receptive_field,
                    "global_classes": cfg.global_classes,
                    "mel": cfg.mel is not None,
                    "stats": dict(engine.stats),
                    "realtime_factor": round(engine.realtime_factor, 3),
                })
            else:
                self._json(404, {"error": "unknown path"})

        def _read_body(self) -> bytes:
            # always drain the body, even on error paths: unread bytes on a
            # keep-alive connection would be parsed as the next request line
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def do_POST(self):
            body = self._read_body()
            if self.path != "/synthesize":
                self._json(404, {"error": "unknown path"})
                return
            try:
                req = json.loads(body or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                seconds = req.get("seconds")
                mel = _decode_f32(req, "mel", cols=(
                    cfg.mel.num_mels if cfg.mel is not None else None))
                prime = _decode_f32(req, "prime")
                handle = engine.submit(
                    seconds=None if seconds is None else float(seconds),
                    num_samples=_opt_int(req.get("num_samples")),
                    seed=int(req.get("seed", 0)),
                    temperature=float(req.get("temperature", 1.0)),
                    speaker=_opt_int(req.get("speaker")),
                    mel=mel, prime=prime)
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            self._committed = False
            try:
                if req.get("stream"):
                    self._stream(handle)
                else:
                    wav = _wav_bytes(handle.waveform(), cfg.sample_rate)
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(wav)))
                    self.end_headers()
                    self._committed = True
                    self.wfile.write(wav)
            except Exception as e:
                if self._committed:
                    # a response is already on the wire: a second status
                    # line would corrupt the chunked framing — drop the
                    # connection so the client sees a hard truncation
                    self.close_connection = True
                    return
                if isinstance(e, ValueError):
                    self._json(400, {"error": str(e)})
                else:
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def _stream(self, handle) -> None:
            """Chunked PCM response; sets self._committed once the 200
            status line is on the wire (the first chunk is pulled
            beforehand so decode failures still map to a clean 400/500)."""
            chunks = iter(handle)
            try:
                first = next(chunks)
            except StopIteration:
                first = None
            self._committed = True
            self.send_response(200)
            self.send_header("Content-Type", "audio/L16")
            self.send_header("X-Sample-Rate", str(cfg.sample_rate))
            self.send_header("X-Num-Samples", str(handle.num_samples))
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(data: bytes):
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            if first is not None:
                emit(_pcm16(first))
            for c in chunks:
                emit(_pcm16(c))
            self.wfile.write(b"0\r\n\r\n")

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server
