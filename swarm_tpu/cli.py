"""Command-line interface.

Option table, duplicate detection, validation, banner/usage display and
the parameter echo — behaviour- and byte-compatible with the reference
CLI (src/swarm.cc:96-630).
"""

import sys

from .fatal import ERROR_PREFIX, fatal
from .getopt_gnu import (
    NO_ARGUMENT,
    REQUIRED_ARGUMENT,
    LongOption,
    getopt_long,
)
from .messages import HEADER_MESSAGE, USAGE_MESSAGE
from .params import Parameters

SHORT_OPTIONS = "a:b:c:d:e:fg:hi:j:l:m:no:p:rs:t:u:vw:xy:z"

LONG_OPTIONS = [
    LongOption("append-abundance", REQUIRED_ARGUMENT, "a"),
    LongOption("boundary", REQUIRED_ARGUMENT, "b"),
    LongOption("ceiling", REQUIRED_ARGUMENT, "c"),
    LongOption("differences", REQUIRED_ARGUMENT, "d"),
    LongOption("gap-extension-penalty", REQUIRED_ARGUMENT, "e"),
    LongOption("fastidious", NO_ARGUMENT, "f"),
    LongOption("gap-opening-penalty", REQUIRED_ARGUMENT, "g"),
    LongOption("help", NO_ARGUMENT, "h"),
    LongOption("internal-structure", REQUIRED_ARGUMENT, "i"),
    LongOption("log", REQUIRED_ARGUMENT, "l"),
    LongOption("network-file", REQUIRED_ARGUMENT, "j"),
    LongOption("match-reward", REQUIRED_ARGUMENT, "m"),
    LongOption("no-otu-breaking", NO_ARGUMENT, "n"),
    LongOption("output-file", REQUIRED_ARGUMENT, "o"),
    LongOption("mismatch-penalty", REQUIRED_ARGUMENT, "p"),
    LongOption("mothur", NO_ARGUMENT, "r"),
    LongOption("statistics-file", REQUIRED_ARGUMENT, "s"),
    LongOption("threads", REQUIRED_ARGUMENT, "t"),
    LongOption("uclust-file", REQUIRED_ARGUMENT, "u"),
    LongOption("version", NO_ARGUMENT, "v"),
    LongOption("seeds", REQUIRED_ARGUMENT, "w"),
    LongOption("disable-sse3", NO_ARGUMENT, "x"),
    LongOption("bloom-bits", REQUIRED_ARGUMENT, "y"),
    LongOption("usearch-abundance", NO_ARGUMENT, "z"),
]

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)


def args_long(value: str, option: str) -> int:
    """strtol(base 10) with the reference's diagnostic on trailing garbage."""
    i = 0
    n = len(value)
    while i < n and value[i] in " \t\n\r\v\f":
        i += 1
    start = i
    if i < n and value[i] in "+-":
        i += 1
    digits_start = i
    while i < n and "0" <= value[i] <= "9":
        i += 1
    if i == digits_start:
        i = 0  # strtol: no conversion -> endptr = original start
        start = digits_start  # nothing parsed
    if i != n:
        # endptr did not consume the whole string
        fatal(
            ERROR_PREFIX,
            "Invalid numeric argument for option ",
            option,
            ".\n\n",
            "Frequent causes are:\n",
            " - a missing space between an argument and the next option,\n",
            " - a long option name not starting with a double dash\n",
            "   (swarm accepts '--help' or '-h', but not '-help')\n\n",
            "Please see 'swarm --help' for more details.",
        )
    number = int(value[start:i]) if i > start else 0
    # strtol saturates on overflow
    return max(INT64_MIN, min(INT64_MAX, number))


def detect_cpu_features(p: Parameters) -> None:
    """Detect host x86 features for log-line compatibility.

    The reference probes cpuid (src/utils/x86_cpu_features.cc); we read
    /proc/cpuinfo which exposes the same flags. Only used for the
    "CPU features:" log line; the device work runs on the GPU.
    """
    try:
        with open("/proc/cpuinfo", "r", encoding="ascii", errors="replace") as fh:
            for line in fh:
                if line.startswith("flags"):
                    flags = set(line.split(":", 1)[1].split())
                    break
            else:
                return
    except OSError:
        return
    p.mmx_present = int("mmx" in flags)
    p.sse_present = int("sse" in flags)
    p.sse2_present = int("sse2" in flags)
    p.sse3_present = int("pni" in flags)
    p.ssse3_present = int("ssse3" in flags)
    p.sse41_present = int("sse4_1" in flags)
    p.sse42_present = int("sse4_2" in flags)
    p.popcnt_present = int("popcnt" in flags)
    p.avx_present = int("avx" in flags)
    p.avx2_present = int("avx2" in flags)


def cpu_features_test(p: Parameters) -> None:
    if p.opt_disable_sse3:
        p.sse3_present = 0
        p.ssse3_present = 0
        p.sse41_present = 0
        p.sse42_present = 0
        p.popcnt_present = 0
        p.avx_present = 0
        p.avx2_present = 0


def cpu_features_show(p: Parameters, logfile) -> None:
    parts = ["CPU features:     "]
    for flag, name in [
        (p.mmx_present, "mmx"),
        (p.sse_present, "sse"),
        (p.sse2_present, "sse2"),
        (p.sse3_present, "sse3"),
        (p.ssse3_present, "ssse3"),
        (p.sse41_present, "sse4.1"),
        (p.sse42_present, "sse4.2"),
        (p.popcnt_present, "popcnt"),
        (p.avx_present, "avx"),
        (p.avx2_present, "avx2"),
    ]:
        if flag:
            parts.append(f" {name}")
    parts.append("\n")
    logfile.write("".join(parts))


def args_init(argv, progname: str, p: Parameters):
    """Parse options; returns the set of used option characters."""
    used_options = set()

    options, positionals, had_error = getopt_long(
        argv, progname, SHORT_OPTIONS, LONG_OPTIONS
    )

    if had_error:
        sys.stderr.write(HEADER_MESSAGE)
        sys.stderr.write(USAGE_MESSAGE)
        fatal()

    for opt, arg in options:
        if "a" <= opt <= "z":
            if opt in used_options:
                long_name = next(lo.name for lo in LONG_OPTIONS if lo.val == opt)
                fatal(
                    ERROR_PREFIX,
                    "Option -",
                    opt,
                    " or --",
                    long_name,
                    " specified more than once.",
                )
            used_options.add(opt)

        if opt == "a":
            p.opt_append_abundance = args_long(arg, "-a or --append-abundance")
        elif opt == "b":
            p.opt_boundary = args_long(arg, "-b or --boundary")
        elif opt == "c":
            p.opt_ceiling = args_long(arg, "-c or --ceiling")
        elif opt == "d":
            p.opt_differences = args_long(arg, "-d or --differences")
        elif opt == "e":
            p.opt_gap_extension_penalty = args_long(arg, "-e or --gap-extension-penalty")
        elif opt == "f":
            p.opt_fastidious = True
        elif opt == "g":
            p.opt_gap_opening_penalty = args_long(arg, "-g or --gap-opening-penalty")
        elif opt == "h":
            p.opt_help = True
        elif opt == "i":
            p.opt_internal_structure = arg
        elif opt == "j":
            p.opt_network_file = arg
        elif opt == "l":
            p.opt_log = arg
        elif opt == "m":
            p.opt_match_reward = args_long(arg, "-m or --match-reward")
        elif opt == "n":
            p.opt_no_cluster_breaking = True
        elif opt == "o":
            p.opt_output_file = arg
        elif opt == "p":
            p.opt_mismatch_penalty = args_long(arg, "-p or --mismatch-penalty")
        elif opt == "r":
            p.opt_mothur = True
        elif opt == "s":
            p.opt_statistics_file = arg
        elif opt == "t":
            p.opt_threads = args_long(arg, "-t or --threads")
        elif opt == "u":
            p.opt_uclust_file = arg
        elif opt == "v":
            p.opt_version = True
        elif opt == "w":
            p.opt_seeds = arg
        elif opt == "x":
            p.opt_disable_sse3 = True
        elif opt == "y":
            p.opt_bloom_bits = args_long(arg, "-y or --bloom-bits")
        elif opt == "z":
            p.opt_usearch_abundance = True

    if positionals:
        p.input_filename = positionals[0]

    detect_cpu_features(p)
    cpu_features_test(p)

    return used_options


def args_check(used_options, p: Parameters) -> None:
    """Validate option values and cross-option constraints.

    Messages byte-identical to the reference (src/swarm.cc:486-630).
    """
    uint8_max = 255
    uint16_max = 65535
    max_threads = 512

    if p.opt_threads < 1 or p.opt_threads > max_threads:
        fatal(
            ERROR_PREFIX,
            "Illegal number of threads specified with "
            "-t or --threads, must be in the range 1 to ",
            max_threads,
            ".",
        )

    if p.opt_differences < 0 or p.opt_differences > uint8_max:
        from .fatal import UINT8_MAX_CHAR

        fatal(
            ERROR_PREFIX,
            "Illegal number of differences specified with -d or --differences, "
            "must be in the range 0 to ",
            UINT8_MAX_CHAR,  # reference streams uint8_t as a raw char
            ".",
        )

    if p.opt_fastidious and p.opt_differences != 1:
        fatal(
            ERROR_PREFIX,
            "Fastidious mode (specified with -f or --fastidious) only works "
            "when the resolution (specified with -d or --differences) is 1.",
        )

    if p.opt_disable_sse3 and p.opt_differences < 2:
        fatal(
            ERROR_PREFIX,
            "Option --disable-sse3 or -x has no effect when d < 2 "
            "(SSE3 instructions are only used when d > 1).",
        )

    if not p.opt_fastidious:
        if "b" in used_options:
            fatal(ERROR_PREFIX, "Option -b or --boundary specified without -f or --fastidious.")
        if "c" in used_options:
            fatal(ERROR_PREFIX, "Option -c or --ceiling specified without -f or --fastidious.")
        if "y" in used_options:
            fatal(ERROR_PREFIX, "Option -y or --bloom-bits specified without -f or --fastidious.")

    if p.opt_differences < 2:
        if "m" in used_options:
            fatal(ERROR_PREFIX, "Option -m or --match-reward specified when d < 2.")
        if "p" in used_options:
            fatal(ERROR_PREFIX, "Option -p or --mismatch-penalty specified when d < 2.")
        if "g" in used_options:
            fatal(ERROR_PREFIX, "Option -g or --gap-opening-penalty specified when d < 2.")
        if "e" in used_options:
            fatal(ERROR_PREFIX, "Option -e or --gap-extension-penalty specified when d < 2.")

    if p.opt_gap_opening_penalty < 0:
        fatal(
            ERROR_PREFIX,
            "Illegal gap opening penalty specified with -g or "
            "--gap-opening-penalty, must not be negative.",
        )

    if p.opt_gap_extension_penalty < 0:
        fatal(
            ERROR_PREFIX,
            "Illegal gap extension penalty specified with -e or "
            "--gap-extension-penalty, must not be negative.",
        )

    if p.opt_gap_opening_penalty + p.opt_gap_extension_penalty < 1:
        fatal(
            ERROR_PREFIX,
            "Illegal gap penalties specified, the sum of the gap open and "
            "the gap extension penalty must be at least 1.",
        )

    if p.opt_match_reward < 1:
        fatal(
            ERROR_PREFIX,
            "Illegal match reward specified with -m or --match-reward, "
            "must be at least 1.",
        )

    if p.opt_mismatch_penalty < 1:
        fatal(
            ERROR_PREFIX,
            "Illegal mismatch penalty specified with -p or --mismatch-penalty, "
            "must be at least 1.",
        )

    if p.opt_boundary < 2:
        fatal(
            ERROR_PREFIX,
            "Illegal boundary specified with -b or --boundary, "
            "must be at least 2.",
        )

    if "c" in used_options and (p.opt_ceiling < 40 or p.opt_ceiling > (1 << 30)):
        fatal(
            ERROR_PREFIX,
            "Illegal memory ceiling specified with -c or --ceiling, "
            "must be in the range 8 to 1,073,741,824 MB.",
        )

    if p.opt_bloom_bits < 2 or p.opt_bloom_bits > 64:
        fatal(
            ERROR_PREFIX,
            "Illegal number of Bloom filter bits specified with -y or "
            "--bloom-bits, must be in the range 2 to 64.",
        )

    if "a" in used_options and p.opt_append_abundance < 1:
        fatal(
            ERROR_PREFIX,
            "Illegal abundance value specified with -a or --append-abundance, "
            "must be at least 1.",
        )

    if p.opt_network_file and p.opt_differences != 1:
        fatal(ERROR_PREFIX, "A network file can only written when d = 1.")

    if p.opt_version:
        sys.stderr.write(HEADER_MESSAGE)
        raise SystemExit(0)

    if p.opt_help:
        sys.stderr.write(HEADER_MESSAGE)
        sys.stderr.write(USAGE_MESSAGE)
        raise SystemExit(0)

    # scoring system saturation checks
    diff_saturation_16 = min(
        uint16_max // p.penalty_mismatch,
        (uint16_max - p.penalty_gapopen) // p.penalty_gapextend,
    )
    if p.opt_differences > diff_saturation_16:
        fatal(ERROR_PREFIX, "Resolution (d) too high for the given scoring system.")

    if p.penalty_mismatch > uint8_max:
        fatal(
            ERROR_PREFIX,
            "Alignment scoring system yielded a mismatch penalty greater than 255, "
            "please use different parameter values.",
        )


def args_show(p: Parameters, logfile) -> None:
    cpu_features_show(p, logfile)
    logfile.write(f"Database file:     {p.input_filename}\n")
    logfile.write(f"Output file:       {p.opt_output_file}\n")
    if p.opt_statistics_file:
        logfile.write(f"Statistics file:   {p.opt_statistics_file}\n")
    if p.opt_uclust_file:
        logfile.write(f"Uclust file:       {p.opt_uclust_file}\n")
    if p.opt_internal_structure:
        logfile.write(f"Int. struct. file  {p.opt_internal_structure}\n")
    if p.opt_network_file:
        logfile.write(f"Network file       {p.opt_network_file}\n")
    logfile.write(f"Resolution (d):    {p.opt_differences}\n")
    logfile.write(f"Threads:           {p.opt_threads}\n")
    if p.opt_differences > 1:
        logfile.write(
            f"Scores:            match: {p.opt_match_reward}, "
            f"mismatch: {p.opt_mismatch_penalty}\n"
        )
        logfile.write(
            f"Gap penalties:     opening: {p.opt_gap_opening_penalty}, "
            f"extension: {p.opt_gap_extension_penalty}\n"
        )
        logfile.write(
            f"Converted costs:   mismatch: {p.penalty_mismatch}, "
            f"gap opening: {p.penalty_gapopen}, "
            f"gap extension: {p.penalty_gapextend}\n"
        )
    logfile.write(f"Break clusters:    {'No' if p.opt_no_cluster_breaking else 'Yes'}\n")
    if p.opt_fastidious:
        logfile.write(f"Fastidious:        Yes, with boundary {p.opt_boundary}\n")
    else:
        logfile.write("Fastidious:        No\n")
    logfile.write("\n")


_STDOUT_WRAPPER = None
_STDERR_WRAPPER = None
_RETIRED_WRAPPERS = []  # keep refs: GC'ing a TextIOWrapper closes its buffer


def make_stdout():
    """Byte-transparent stdout wrapper (cached: a dropped TextIOWrapper
    would close sys.stdout.buffer when garbage-collected). Re-created
    when the stream was swapped or closed (e.g. contextlib redirects
    in an embedding process)."""
    import io

    global _STDOUT_WRAPPER
    buf = getattr(sys.stdout, "buffer", None)
    if buf is None:
        return sys.stdout
    if (
        _STDOUT_WRAPPER is None
        or _STDOUT_WRAPPER.closed
        or _STDOUT_WRAPPER.buffer is not buf
    ):
        if _STDOUT_WRAPPER is not None:
            _RETIRED_WRAPPERS.append(_STDOUT_WRAPPER)
        _STDOUT_WRAPPER = io.TextIOWrapper(
            buf, encoding="latin-1", newline=""
        )
    return _STDOUT_WRAPPER


def make_stderr():
    import io

    global _STDERR_WRAPPER
    buf = getattr(sys.stderr, "buffer", None)
    if buf is None:
        return sys.stderr
    if (
        _STDERR_WRAPPER is None
        or _STDERR_WRAPPER.closed
        or _STDERR_WRAPPER.buffer is not buf
    ):
        if _STDERR_WRAPPER is not None:
            _RETIRED_WRAPPERS.append(_STDERR_WRAPPER)
        _STDERR_WRAPPER = io.TextIOWrapper(
            buf, encoding="latin-1", newline="", write_through=True
        )
    return _STDERR_WRAPPER


def write_blob(f, blob: bytes) -> None:
    """Write a native writer's byte blob to a latin-1 text stream
    without the decode + re-encode round trip (two full passes over a
    35 MB stats blob at 1M amplicons). The text layer is flushed first
    so interleaved text writes keep their order."""
    buf = getattr(f, "buffer", None)
    if buf is not None:
        f.flush()
        buf.write(blob)
    else:
        f.write(blob.decode("latin-1"))


def open_files(p: Parameters) -> None:
    """Open the output streams; '-' means stdout (src/utils/open_and_close_files.cc).

    All streams are byte-transparent (latin-1) because fasta headers may
    contain arbitrary bytes that must round-trip unchanged."""

    def fopen_output(filename: str):
        if filename == "-":
            # the reference dups stdout per '-' stream (fopen_output,
            # src/utils/input_output.cc:46-60): each one gets an
            # INDEPENDENT 4 KiB-buffered FILE* flushed only at fclose,
            # while the log is flushed eagerly at progress marks — that
            # buffering structure decides the byte ORDER on fd 1 when
            # several streams share it (e.g. `-l -` with default -o).
            # The resident server's stdout shim has no real fd; fall
            # back to the shared wrapper there.
            import io
            import os

            try:
                sys.stdout.flush()
                fd = os.dup(sys.stdout.fileno())
            except (AttributeError, OSError, ValueError,
                    io.UnsupportedOperation):
                return make_stdout()
            return io.TextIOWrapper(
                io.BufferedWriter(io.FileIO(fd, "wb"), 4096),
                encoding="latin-1", newline="",
            )
        try:
            return open(filename, "w", newline="", encoding="latin-1")
        except OSError:
            return None

    p.outfile = fopen_output(p.opt_output_file)
    if p.outfile is None:
        fatal(ERROR_PREFIX, "Unable to open output file for writing.")

    if p.opt_log:
        p.logfile = fopen_output(p.opt_log)
        if p.logfile is None:
            fatal(ERROR_PREFIX, "Unable to open log file for writing.")
    else:
        p.logfile = make_stderr()

    if p.opt_seeds:
        p.seeds_file = fopen_output(p.opt_seeds)
        if p.seeds_file is None:
            fatal(ERROR_PREFIX, "Unable to open seeds file for writing.")

    if p.opt_statistics_file:
        p.statsfile = fopen_output(p.opt_statistics_file)
        if p.statsfile is None:
            fatal(ERROR_PREFIX, "Unable to open statistics file for writing.")

    if p.opt_uclust_file:
        p.uclustfile = fopen_output(p.opt_uclust_file)
        if p.uclustfile is None:
            fatal(ERROR_PREFIX, "Unable to open uclust file for writing.")

    if p.opt_internal_structure:
        p.internal_structure_file = fopen_output(p.opt_internal_structure)
        if p.internal_structure_file is None:
            fatal(ERROR_PREFIX, "Unable to open internal structure file for writing.")

    if p.opt_network_file:
        p.network_file = fopen_output(p.opt_network_file)
        if p.network_file is None:
            fatal(ERROR_PREFIX, "Unable to open network file for writing.")


def close_files(p: Parameters) -> None:
    for handle in (
        p.network_file,
        p.internal_structure_file,
        p.uclustfile,
        p.statsfile,
        p.seeds_file,
        p.outfile,
        p.logfile,
    ):
        if handle is not None:
            handle.flush()
            if getattr(handle, "buffer", None) not in (
                getattr(sys.stdout, "buffer", None),
                getattr(sys.stderr, "buffer", None),
                None,
            ):
                handle.close()
