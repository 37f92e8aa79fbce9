"""Refinement over several frames (the port of plo_tpu/parallel): the
windowed bundle adjustment on one device. The sharded forms of plo_tpu's
package (make_distributed_refine, the map store, the sharded odometry) are
not ported yet."""
