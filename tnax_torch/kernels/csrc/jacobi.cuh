// The rotation of one-sided (Hestenes) Jacobi, shared by K6 (zipup.cu, the
// ladder's zip-up SVDs) and K7 (svd.cu, the boundary's SVDs): for the
// column pair whose square norms and inner product are al, be, ga, the
// rotation (cs, sn) with tn = sn / cs that makes the pair orthogonal, or
// false when the pair is left as it is:
//   - the pair is orthogonal to the columns' float32 precision, |ga| at
//     most tol sqrt(al be), tol = sqrt(rows) eps (LAPACK's sgesvj:
//     rounding keeps inner products of converged columns above eps alone,
//     and the sweeps would not end);
//   - a column is negligible, its square norm at most floor2: rounding
//     noise of a rank-deficient matrix, whose rows lie in the span of the
//     others, so rotations would only trade one residual of a few eps for
//     another and never converge. Each kernel sets floor2 from its
//     matrix's norm.
// The caller stops when a sweep rotates nothing, at most 30 sweeps.

#pragma once

__device__ __forceinline__ bool jacobi_rotation(float al, float be, float ga,
                                                float tol, float floor2,
                                                float& cs, float& sn,
                                                float& tn) {
  if (al <= floor2 || be <= floor2 ||
      !(fabsf(ga) > tol * sqrtf(al) * sqrtf(be)))
    return false;
  const float zeta = (be - al) / (2.f * ga);
  tn = copysignf(1.f, zeta) / (fabsf(zeta) + sqrtf(fmaf(zeta, zeta, 1.f)));
  cs = 1.f / sqrtf(fmaf(tn, tn, 1.f));
  sn = cs * tn;
  return true;
}
