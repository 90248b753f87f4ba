"""The benchmark's harness: discovery by name (``manifest``), the run
(``driver``), its spans and window (``hooks``), the profiled stretch
(``trace``), the correctness check (``check``), the controls (``control``),
initial weights (``weights``), the card's peaks (``peaks``) and what the
per-layer metric files share (``readers``)."""
