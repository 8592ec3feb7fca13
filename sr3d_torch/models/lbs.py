"""Linear blend skinning for FLAME (fp32, batch-first, ``[B, V, 3]``).

Counterpart of ``sr3d_tpu/models/lbs.py``, the standard SMPL/FLAME LBS
pipeline; the kinematic chain is a Python loop over the J = 5 joints.
The joint tree's constant indices go to the device once (``index_on``):
indexing with a Python list copies the list from host memory at every
call, and that copy waits for everything queued on the device.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=16)
def index_on(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The int64 index ``values`` on ``device``, copied there once;
    ``t[:, index_on(v, t.device)]`` is ``t[:, list(v)]``."""
    return torch.tensor(values, dtype=torch.long).to(device)


def batch_rodrigues(rot_vecs: torch.Tensor, epsilon: float = 1e-8
                    ) -> torch.Tensor:
    """Axis-angle ``[N, 3]`` → rotation matrices ``[N, 3, 3]``, with the
    ``+1e-8`` that keeps zero poses well defined."""
    angle = torch.linalg.norm(rot_vecs + epsilon, dim=1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[:, None, :]
    sin = torch.sin(angle)[:, None, :]
    rx, ry, rz = rot_dir.split(1, dim=1)
    zeros = torch.zeros_like(rx)
    K = torch.cat([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                  dim=1).view(-1, 3, 3)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)[None]
    return ident + sin * K + (1.0 - cos) * torch.matmul(K, K)


def rot_mat_to_euler(rot_mats: torch.Tensor) -> torch.Tensor:
    """Y-axis Euler angle of rotation matrices ``[N, 3, 3]``."""
    sy = torch.sqrt(rot_mats[:, 0, 0] * rot_mats[:, 0, 0]
                    + rot_mats[:, 1, 0] * rot_mats[:, 1, 0])
    return torch.atan2(-rot_mats[:, 2, 0], sy)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor
                 ) -> torch.Tensor:
    """``[B, L]`` × ``[V, 3, L]`` → ``[B, V, 3]`` displacements."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor
                    ) -> torch.Tensor:
    """``[J, V]`` × ``[B, V, 3]`` → ``[B, J, 3]``."""
    return torch.einsum("bik,ji->bjk", vertices, J_regressor)


def vertices2landmarks(vertices: torch.Tensor, faces: torch.Tensor,
                       lmk_faces_idx: torch.Tensor,
                       lmk_bary_coords: torch.Tensor) -> torch.Tensor:
    """Barycentric landmarks: vertices ``[B, V, 3]``, faces ``[F, 3]``,
    ``lmk_faces_idx`` ``[B, L]`` or ``[L]``, ``lmk_bary_coords``
    ``[B, L, 3]`` or ``[L, 3]`` → ``[B, L, 3]``."""
    B = vertices.shape[0]
    if lmk_faces_idx.dim() == 1:
        lmk_faces_idx = lmk_faces_idx[None].expand(B, -1)
    if lmk_bary_coords.dim() == 2:
        lmk_bary_coords = lmk_bary_coords[None].expand(B, -1, -1)
    lmk_faces = faces[lmk_faces_idx.long()].long()            # [B, L, 3]
    batch = torch.arange(B, device=vertices.device)[:, None, None]
    lmk_vertices = vertices[batch, lmk_faces]                 # [B, L, 3, 3]
    return torch.einsum("blfi,blf->bli", lmk_vertices, lmk_bary_coords)


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3]`` + ``[..., 3, 1]`` → ``[..., 4, 4]``."""
    top = torch.cat([R, t], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics over the joint tree (``parents[0] == -1``,
    topologically ordered).  Returns posed joints ``[B, J, 3]`` and relative
    transforms ``[B, J, 4, 4]``."""
    B, J = joints.shape[:2]
    par = [int(p) for p in parents.tolist()]
    rel_joints = joints.clone()
    rel_joints[:, 1:] -= joints[:, index_on(tuple(par[1:]), joints.device)]
    transforms_mat = transform_mat(rot_mats, rel_joints[..., None])
    chain = [transforms_mat[:, 0]]
    for j in range(1, J):
        chain.append(torch.matmul(chain[par[j]], transforms_mat[:, j]))
    transforms = torch.stack(chain, dim=1)
    posed_joints = transforms[:, :, :3, 3]
    joints_homogen = torch.cat(
        [joints[..., None], joints.new_zeros(B, J, 1, 1)], dim=2)
    correction = torch.matmul(transforms, joints_homogen)       # [B, J, 4, 1]
    rel_transforms = transforms - torch.nn.functional.pad(correction,
                                                          (3, 0))
    return posed_joints, rel_transforms


def lbs(betas: torch.Tensor, pose: torch.Tensor, v_template: torch.Tensor,
        shapedirs: torch.Tensor, posedirs: torch.Tensor,
        J_regressor: torch.Tensor, parents: torch.Tensor,
        lbs_weights: torch.Tensor, pose2rot: bool = True
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blendshapes → joints → pose offsets → kinematics → skinning.
    Returns (vertices ``[B, V, 3]``, joints ``[B, J, 3]``)."""
    B = max(betas.shape[0], pose.shape[0])
    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    J = vertices2joints(J_regressor, v_shaped)
    ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    if pose2rot:
        rot_mats = batch_rodrigues(pose.reshape(-1, 3)).view(B, -1, 3, 3)
        pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    else:
        pose_feature = (pose[:, 1:].reshape(B, -1, 3, 3) - ident) \
            .reshape(B, -1)
        rot_mats = pose.reshape(B, -1, 3, 3)
    pose_offsets = torch.matmul(pose_feature, posedirs).view(B, -1, 3)
    v_posed = pose_offsets + v_shaped
    J_transformed, A = batch_rigid_transform(rot_mats, J, parents)
    num_joints = J_regressor.shape[0]
    W = lbs_weights[None].expand(B, -1, -1)
    T = torch.matmul(W, A.reshape(B, num_joints, 16)).view(B, -1, 4, 4)
    ones = v_posed.new_ones(B, v_posed.shape[1], 1)
    v_homo = torch.matmul(T, torch.cat([v_posed, ones], dim=2)[..., None])
    return v_homo[:, :, :3, 0], J_transformed
