// What one build unit of a kernel source compiles.  kernels/build.py
// builds csrc/pathgen.cu and csrc/pathgen_tiled.cu as four units each and
// csrc/pathgen_factored.cu as two, all in parallel, so the build's wall is
// the slowest unit's and not a source's:
//   MCOP_UNIT_BF16=1    the bf16 fGN-input bodies (else the float32 ones);
//   MCOP_UNIT_SEEDED=1  the seeded bodies only (Philox in the kernel),
//   MCOP_UNIT_SEEDED=0  the noise-in bodies only (unset: both).
// A unit's C entries carry the suffix of what it holds (MCOP_ENTRY:
// _bf16, _seeded, _bf16_seeded), and an entry asked for a body its unit
// does not hold returns cudaErrorInvalidValue: nothing runs another body.
#pragma once

#ifndef MCOP_UNIT_BF16
#define MCOP_UNIT_BF16 0
#endif
#ifndef MCOP_UNIT_SEEDED
#define MCOP_UNIT_SEEDED -1
#endif

// The phases K1/K2, K6/K7 and P1's matmul run (a bit mask, every phase
// unless a measurement build leaves some out: kernels/phase_split.py times
// a phase by difference, and such a build's results mean nothing).
#ifndef MCOP_PHASES
#define MCOP_PHASES 15
#endif

#if MCOP_UNIT_BF16 && MCOP_UNIT_SEEDED == 1
#define MCOP_ENTRY(name) name##_bf16_seeded
#elif MCOP_UNIT_BF16
#define MCOP_ENTRY(name) name##_bf16
#elif MCOP_UNIT_SEEDED == 1
#define MCOP_ENTRY(name) name##_seeded
#else
#define MCOP_ENTRY(name) name
#endif

namespace mcop {

// The fGN input dtype of this unit's bodies.
constexpr bool kUnitBf16 = MCOP_UNIT_BF16 != 0;
// Whether this unit holds the seeded and the noise-in bodies.
constexpr bool kUnitSeeded = MCOP_UNIT_SEEDED != 0;
constexpr bool kUnitNoiseIn = MCOP_UNIT_SEEDED != 1;

// The phases: the seeded draw, the variance exp and Euler increment (with
// W), the running sum, and the decision or the price stores (P1: the draw
// of a0 and the writes of each step's a).  The product always runs.
constexpr unsigned kPhaseDraw = 1u, kPhaseEuler = 2u, kPhaseScan = 4u,
                   kPhaseOut = 8u;
constexpr unsigned kPhases = MCOP_PHASES;

}  // namespace mcop
