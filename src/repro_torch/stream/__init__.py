"""Streaming subsequence search (port of ``repro.stream``, univariate;
DESIGN.md §3.5).

Watches an unbounded signal and reports every subsequence matching a
template bank, through the same LB_Keogh -> LB_Improved -> DTW cascade
the database search uses — windows as candidate lanes, templates as the
query batch, one batched sweep per window block on the device.

* ``StreamState`` — ring buffer + Lemire monotonic-deque online
  envelope (O(1)/sample) + rolling window mean/variance, in numpy on
  the host.
* ``SubsequenceScanner`` / ``windowed_matches`` — hop-strided window
  blocks through the shared cascade with an S0 stream-envelope
  prefilter and per-stage prune stats; without z-normalization the
  first pass is the stream-packed LB_Keogh kernel (K7) over the block's
  flat segment.
* ``StreamMatcher`` — push-samples / poll-matches service with
  streaming trivial-match exclusion (emits exactly the offline scan's
  match set, incrementally).
"""

from repro_torch.stream.matcher import StreamMatcher, windowed_matches
from repro_torch.stream.state import (
    StreamState,
    prefix_sums,
    window_mean_std_from_prefix,
)
from repro_torch.stream.subsequence import (
    Match,
    StreamStats,
    SubsequenceScanner,
    greedy_suppress,
    num_windows,
    suppress_stream,
    znorm_series,
    znorm_windows,
)

__all__ = [
    "Match",
    "StreamMatcher",
    "StreamState",
    "StreamStats",
    "SubsequenceScanner",
    "greedy_suppress",
    "num_windows",
    "prefix_sums",
    "suppress_stream",
    "window_mean_std_from_prefix",
    "windowed_matches",
    "znorm_series",
    "znorm_windows",
]
