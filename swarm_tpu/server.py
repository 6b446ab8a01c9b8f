"""Resident server: a warm swarm process serving CLI requests.

The reference is a static binary with zero startup cost
(src/swarm.cc:633 goes straight to work). A Python+XLA process instead
pays interpreter start, imports, device start-up and executable loads
from the compile cache. The server keeps all of that warm across
invocations: one
long-lived process holds the imported modules, the native library,
the jitted-program caches, and the device runtime; each CLI request
then costs only the engine time.

Protocol (one request per connection, newline-framed JSON over a unix
socket):

  client -> server   {"argv": [...], "cwd": "...", "stdin_b64": "..."}
  server -> client   {"s": 1, "d": "<b64>"}   stdout chunk
                     {"s": 2, "d": "<b64>"}   stderr chunk
                     {"rc": N}                done
server:  python -m swarm_tpu.server /path/to.sock
client:  SWARM_TPU_SERVER=/path/to.sock bin/swarm [OPTIONS] [FASTAFILE]
         (bin/swarm forwards automatically when the variable is set and
         the socket accepts; the client imports only the stdlib, so a
         forwarded run costs ~50 ms of process overhead)

Output FILES named in argv are written by the server process itself
(same filesystem, paths resolved against the client's cwd); only the
stdout/stderr byte streams travel over the socket, so '-' outputs and
progress indicators work transparently and stay byte-identical.
"""

import base64
import io
import json
import os
import socket
import sys

__all__ = ["serve", "forward", "main"]


class _FrameRaw(io.RawIOBase):
    """Binary stream that frames every write as a JSON line."""

    def __init__(self, wfile, stream_id):
        self._wfile = wfile
        self._sid = stream_id

    def writable(self):
        return True

    def write(self, b):
        b = bytes(b)
        if b:
            self._wfile.write(
                (
                    json.dumps(
                        {"s": self._sid, "d": base64.b64encode(b).decode()}
                    )
                    + "\n"
                ).encode()
            )
            self._wfile.flush()
        return len(b)


class _TextShim:
    """Minimal text-stream stand-in for sys.stdout/sys.stderr whose
    .buffer is a framed socket stream; cli.make_stdout/make_stderr wrap
    .buffer in their own latin-1 TextIOWrapper, so everything the CLI
    writes reaches the client byte-identical."""

    def __init__(self, buffer):
        self.buffer = buffer
        self.encoding = "latin-1"
        self.closed = False

    def write(self, s):
        self.buffer.write(s.encode("latin-1", "replace"))
        return len(s)

    def flush(self):
        pass

    def isatty(self):
        return False

    def fileno(self):
        raise io.UnsupportedOperation("fileno")


class _StdinShim:
    def __init__(self, payload: bytes):
        self.buffer = io.BytesIO(payload)
        self.encoding = "latin-1"

    def read(self, *a):
        return self.buffer.read(*a).decode("latin-1")


def _handle(conn):
    from .fatal import FatalError
    from .main import run

    rfile = conn.makefile("rb")
    wfile = conn.makefile("wb")
    line = rfile.readline()
    if not line:
        return False
    req = json.loads(line)
    if req.get("op") == "shutdown":
        wfile.write(b'{"rc": 0}\n')
        wfile.flush()
        return True
    if req.get("op") == "ping":
        wfile.write(b'{"rc": 0}\n')
        wfile.flush()
        return False

    argv = req["argv"]
    cwd = req.get("cwd")
    payload = base64.b64decode(req.get("stdin_b64", ""))

    out_shim = _TextShim(_FrameRaw(wfile, 1))
    err_shim = _TextShim(_FrameRaw(wfile, 2))
    old = (sys.stdout, sys.stderr, sys.stdin, os.getcwd())
    rc = 0
    try:
        sys.stdout, sys.stderr = out_shim, err_shim
        sys.stdin = _StdinShim(payload)
        if cwd:
            os.chdir(cwd)
        try:
            rc = run(argv, req.get("progname", "swarm"))
        except FatalError:
            rc = 1
    except BrokenPipeError:
        return False
    except Exception:  # report, keep serving
        import traceback

        try:
            err_shim.write(traceback.format_exc())
        except Exception:
            pass
        rc = 70
    finally:
        sys.stdout, sys.stderr, sys.stdin = old[:3]
        try:
            os.chdir(old[3])
        except OSError:
            pass
    try:
        wfile.write(json.dumps({"rc": rc}).encode() + b"\n")
        wfile.flush()
    except BrokenPipeError:
        pass
    return False


def serve(sock_path: str, ready_fd: int = None) -> None:
    """Accept requests until a shutdown request arrives."""
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    os.chmod(sock_path, 0o700)
    srv.listen(8)
    if ready_fd is not None:
        os.write(ready_fd, b"ready\n")
        os.close(ready_fd)
    try:
        while True:
            conn, _ = srv.accept()
            try:
                if _handle(conn):
                    break
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
    finally:
        srv.close()
        try:
            os.unlink(sock_path)
        except OSError:
            pass


def forward(sock_path: str, argv, progname: str = "swarm",
            conn=None) -> int:
    """Run argv on the resident server; returns the exit code.
    Raises OSError when no server is listening (callers that want a
    fallback should connect first and pass `conn`)."""
    if conn is None:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.connect(sock_path)
    stdin_b64 = ""
    fastafile = [a for a in argv if a == "-"]
    # stdin is consumed when the input is '-' or absent AND the request
    # is not pure option probing (--help/--version exit before reading)
    reads_stdin = bool(fastafile) or not _has_input_file(argv)
    if reads_stdin and not sys.stdin.isatty():
        stdin_b64 = base64.b64encode(sys.stdin.buffer.read()).decode()
    req = {
        "argv": list(argv),
        "cwd": os.getcwd(),
        "progname": progname,
        "stdin_b64": stdin_b64,
    }
    wfile = conn.makefile("wb")
    rfile = conn.makefile("rb")
    wfile.write(json.dumps(req).encode() + b"\n")
    wfile.flush()
    out = getattr(sys.stdout, "buffer", sys.stdout)
    err = getattr(sys.stderr, "buffer", sys.stderr)
    rc = 70
    for line in rfile:
        msg = json.loads(line)
        if "rc" in msg:
            rc = msg["rc"]
            break
        data = base64.b64decode(msg["d"])
        if msg["s"] == 1:
            out.write(data)
            out.flush()
        else:
            err.write(data)
            err.flush()
    conn.close()
    return rc


# short options that take a value (cli.py SHORT_OPTIONS =
# "a:b:c:d:e:fg:hi:j:l:m:no:p:rs:t:u:vw:xy:z"); used only to guess
# whether a positional input file is present, so the client knows
# whether to forward its stdin (a wrong guess merely forwards unused
# stdin bytes or reads an EOF pipe - it cannot corrupt the run)
_VALUE_OPTS = set("abcdegijlmopstuwy")


def _has_input_file(argv) -> bool:
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "-":
            return True
        if a.startswith("--"):
            if "=" not in a and a[2:] in (
                "append-abundance", "bloom-bits", "boundary", "ceiling",
                "differences", "gap-extension-penalty",
                "gap-opening-penalty", "internal-structure", "log",
                "match-reward", "mismatch-penalty", "network-file",
                "output-file", "seeds", "statistics-file", "threads",
                "uclust-file",
            ):
                skip = True
            continue
        if a.startswith("-") and len(a) >= 2:
            # walk a short-option cluster: the first value-taking char
            # consumes the rest of the token or the next token
            for k, ch in enumerate(a[1:], start=1):
                if ch in _VALUE_OPTS:
                    if k == len(a) - 1:
                        skip = True
                    break
            continue
        return True
    return False


def shutdown(sock_path: str) -> None:
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.connect(sock_path)
    wfile = conn.makefile("wb")
    wfile.write(b'{"op": "shutdown"}\n')
    wfile.flush()
    conn.makefile("rb").readline()
    conn.close()


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] in ("-h", "--help"):
        sys.stderr.write(
            "usage: python -m swarm_tpu.server SOCKET_PATH [--shutdown]\n"
        )
        return 0 if args else 1
    if len(args) > 1 and args[1] == "--shutdown":
        shutdown(args[0])
        return 0
    serve(args[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
