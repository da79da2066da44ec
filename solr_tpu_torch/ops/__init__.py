"""Vector math, intersections, packet traversal, the sweep kernels,
shading and the render loop."""
