# forge3d_tpu/labels — cartographic label engine.
#
# Parity notes (reference behavior, not code): /root/reference/src/labels/
# (23.9k LoC) provides an MSDF glyph atlas + fonts, text shaping, line/curved
# labels, callouts, collision detection (grid + R-tree), declutter solvers
# (greedy / simulated annealing / bounded-optimal with rationale,
# declutter.rs:159-318, optimal.rs), and screen-space projection with depth
# occlusion + horizon fade. Python planner: python/forge3d/label_plan.py.
#
# Design: glyph SDF atlas baked host-side (PIL raster + exact
# euclidean distance transform), text composited analytically from the SDF
# (bilinear sample + smoothstep threshold) — no raster pipeline needed.
# Collision + declutter are host-side combinatorial code, as in the
# reference.

from .atlas import GlyphAtlas, bake_msdf_atlas
from .collision import CollisionGrid, RTree
from .declutter import declutter_greedy, declutter_annealing, declutter_optimal
from .plan import (LabelCandidate, LabelPlacement, LabelPlan, plan_labels,
                   point_label_candidates, line_label_candidates)
from .render import draw_text_rgba, render_label_overlay
from .shape import ShapedGlyph, ShapedRun, text_shape

__all__ = [
    "GlyphAtlas", "bake_msdf_atlas",
    "text_shape", "ShapedGlyph", "ShapedRun",
    "draw_text_rgba", "render_label_overlay",
    "CollisionGrid", "RTree",
    "declutter_greedy", "declutter_annealing", "declutter_optimal",
    "LabelCandidate", "LabelPlacement", "LabelPlan", "plan_labels",
    "point_label_candidates", "line_label_candidates",
]
