"""K7 (``csrc/scan_cells.cu``): the ``cells`` LiDAR scan's sweep.  The
work a lane needs is that of its in-range boundary cells: per cell its
centre, packed id, offset, distance and range test (18 operations), and
per pair of such a cell and a beam the corner-span test and the running
minimum (11), as ``chip_smoke.k7_ops`` counts them.  The cells in range
are counted here from the true map and the scan poses."""

import torch

CELL_OPS = 18
PAIR_OPS = 11


def ops(in_range: int, nb: int) -> int:
    return in_range * (CELL_OPS + PAIR_OPS * nb)


def nbytes(in_range: int, lanes: int, nb: int) -> int:
    """The in-range cells' coordinates read, per lane its waypoint and
    sensor read, per beam its direction and support read and its distance
    and cell written."""
    return 8 * in_range + lanes * (12 + 20 * nb)


def boundary_cells(occ: torch.Tensor) -> torch.Tensor:
    """(M, 2) pixels of the occupied cells with a free 8-neighbour (out of
    the image counts as free)."""
    occupied = occ < 0.5
    free = torch.nn.functional.pad(~occupied, (1, 1, 1, 1), value=True)
    H, W = occupied.shape
    near = torch.zeros_like(occupied)
    for dy in range(3):
        for dx in range(3):
            if dy != 1 or dx != 1:
                near |= free[dy:dy + H, dx:dx + W]
    ys, xs = torch.nonzero(occupied & near, as_tuple=True)
    return torch.stack([xs, ys], -1)


def in_range(cells: torch.Tensor, origin, res: float, rng: float,
             x: torch.Tensor, y: torch.Tensor, chunk: int = 1024) -> int:
    """Sum over the poses (x, y) of the boundary cells whose centre lies
    within (0, rng) of the sensor, the centre of the pose's cell; in the
    configuration's float32, as the scan tests its range."""
    f32 = torch.float32
    o = torch.tensor(origin, dtype=f32, device=x.device)
    r = torch.tensor(res, dtype=f32, device=x.device)
    gx = (cells[:, 0].to(f32) + 0.5) * r + o[0]
    gy = (cells[:, 1].to(f32) + 0.5) * r + o[1]
    sx = (torch.floor((x.to(f32) - o[0]) / r) + 0.5) * r + o[0]
    sy = (torch.floor((y.to(f32) - o[1]) / r) + 0.5) * r + o[1]
    total = 0
    for i in range(0, sx.shape[0], chunk):
        dx = gx[None] - sx[i:i + chunk, None]
        dy = gy[None] - sy[i:i + chunk, None]
        d = torch.sqrt(dx * dx + dy * dy)
        total += int(((d < rng) & (d > 0)).sum())
    return total
