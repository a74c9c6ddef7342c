// Native host-side kernels for the data pipeline.
//
// The reference leans on out-of-tree native code for these (spconv's C++
// VoxelGenerator in the dataloader, reference core/preprocess.py:18-33;
// numpy geometry taking ~10ms/scene, core/geometry.py:28). This library
// provides the same semantics as small, dependency-free C++ exposed over
// a C ABI (loaded with ctypes — no pybind11 in this image):
//
//   * hard_voxelize: sequential first-come voxelization, bit-identical to
//     vision3d_tpu_torch.core.voxelize.voxelize_np (and the device path).
//   * points_in_cuboids_mask: z-slab + BEV polygon membership.
//   * filter_camera_fov: KITTI image-plane visibility mask.
//
// A copy of vision3d_tpu/csrc/vision3d_host.cpp for the PyTorch port.
// Build: vision3d_tpu_torch/utils/native.py compiles it at first use
// (g++ -O3 -shared -fPIC -std=c++17) into vision3d_tpu_torch/build/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// points (n, c) row-major float32, first 3 cols xyz.
// Outputs sized by caller: features (max_voxels, max_occ, c),
// coords (max_voxels, 3) int32 ZYX, occupancy (max_voxels,) int32.
// Returns number of voxels created.
int hard_voxelize(const float* points, int n, int c,
                  const float* voxel_size, const float* bounds_lo,
                  const int* grid_dims_xyz, int max_voxels, int max_occ,
                  float* features, int32_t* coords, int32_t* occupancy) {
  std::unordered_map<int64_t, int> table;
  table.reserve(max_voxels * 2);
  std::memset(features, 0, sizeof(float) * (size_t)max_voxels * max_occ * c);
  std::memset(coords, 0, sizeof(int32_t) * (size_t)max_voxels * 3);
  std::memset(occupancy, 0, sizeof(int32_t) * (size_t)max_voxels);
  const int nx = grid_dims_xyz[0], ny = grid_dims_xyz[1], nz = grid_dims_xyz[2];
  int num_voxels = 0;
  for (int i = 0; i < n; ++i) {
    const float* p = points + (size_t)i * c;
    int cx = (int)std::floor((p[0] - bounds_lo[0]) / voxel_size[0]);
    int cy = (int)std::floor((p[1] - bounds_lo[1]) / voxel_size[1]);
    int cz = (int)std::floor((p[2] - bounds_lo[2]) / voxel_size[2]);
    if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz)
      continue;
    int64_t key = ((int64_t)cz * ny + cy) * nx + cx;
    auto it = table.find(key);
    int v;
    if (it == table.end()) {
      if (num_voxels >= max_voxels) continue;
      v = num_voxels++;
      table.emplace(key, v);
      coords[(size_t)v * 3 + 0] = cz;
      coords[(size_t)v * 3 + 1] = cy;
      coords[(size_t)v * 3 + 2] = cx;
    } else {
      v = it->second;
    }
    int32_t& occ = occupancy[v];
    if (occ < max_occ) {
      std::memcpy(features + ((size_t)v * max_occ + occ) * c, p,
                  sizeof(float) * c);
      ++occ;
    }
  }
  return num_voxels;
}

// points (n, >=3), boxes (m, 7) [x y z w l h yaw]; out (n, m) uint8.
void points_in_cuboids_mask(const float* points, int n, int stride,
                            const float* boxes, int m, uint8_t* out) {
  std::vector<float> cx(m), cy(m), cz(m), hw(m), hl(m), hh(m), cs(m), sn(m);
  for (int j = 0; j < m; ++j) {
    const float* b = boxes + (size_t)j * 7;
    cx[j] = b[0]; cy[j] = b[1]; cz[j] = b[2];
    hw[j] = b[3] * 0.5f; hl[j] = b[4] * 0.5f; hh[j] = b[5] * 0.5f;
    cs[j] = std::cos(b[6]); sn[j] = std::sin(b[6]);
  }
  for (int i = 0; i < n; ++i) {
    const float* p = points + (size_t)i * stride;
    for (int j = 0; j < m; ++j) {
      float dx = p[0] - cx[j], dy = p[1] - cy[j], dz = p[2] - cz[j];
      // local frame: +x along box w (yaw direction), +y along l
      float lx = dx * cs[j] + dy * sn[j];
      float ly = -dx * sn[j] + dy * cs[j];
      out[(size_t)i * m + j] =
          (std::fabs(lx) < hw[j] && std::fabs(ly) < hl[j] &&
           std::fabs(dz) < hh[j])
              ? 1
              : 0;
    }
  }
}

// KITTI FOV crop: keep[i] = point projects into image2.
// P2 (3x4), R0 (3x3), V2C (3x4) row-major; wh = (width, height).
void filter_camera_fov(const float* points, int n, int stride,
                       const float* P2, const float* R0, const float* V2C,
                       const float* wh, uint8_t* keep) {
  // M = R0 @ V2C : (3x4)
  float M[12];
  for (int r = 0; r < 3; ++r)
    for (int col = 0; col < 4; ++col) {
      float s = 0;
      for (int k = 0; k < 3; ++k) s += R0[r * 3 + k] * V2C[k * 4 + col];
      M[r * 4 + col] = s;
    }
  for (int i = 0; i < n; ++i) {
    const float* p = points + (size_t)i * stride;
    if (p[0] <= 0) { keep[i] = 0; continue; }
    float cam[4];
    for (int r = 0; r < 3; ++r)
      cam[r] = M[r * 4 + 0] * p[0] + M[r * 4 + 1] * p[1] +
               M[r * 4 + 2] * p[2] + M[r * 4 + 3];
    cam[3] = 1.0f;
    float img[3];
    for (int r = 0; r < 3; ++r)
      img[r] = P2[r * 4 + 0] * cam[0] + P2[r * 4 + 1] * cam[1] +
               P2[r * 4 + 2] * cam[2] + P2[r * 4 + 3] * cam[3];
    float u = img[0] / img[2], v = img[1] / img[2];
    keep[i] = (u >= 0 && u <= wh[0] && v >= 0 && v <= wh[1]) ? 1 : 0;
  }
}

}  // extern "C"
