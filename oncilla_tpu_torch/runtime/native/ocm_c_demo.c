/* ocm_c_demo — a pure-C application driving the oncilla-tpu cluster
 * through libocm_tpu.so, covering the shapes of the reference's
 * test/ocm_test.c: test 1 (alloc lifecycle + localbuf + introspection),
 * test 2 (one-sided write + read-back verify, both through explicit
 * buffers and through the handle's localbuf via ocmc_copy_onesided), and
 * test 3's host arm (handle-to-handle ocmc_copy).
 *
 * Usage: ocm_c_demo NODEFILE RANK [NBYTES [EXPECT_NNODES [KIND]]]
 * KIND "device" runs the journey on OCMC_KIND_REMOTE_DEVICE — the bytes
 * live in the SPMD controller's plane arena and the daemons relay this
 * app's one-sided ops there (a controller with ici_plane= must be
 * attached somewhere in the cluster).
 * With EXPECT_NNODES > 1 the demo first polls the master's membership
 * until that many daemons joined (a still-joining cluster demotes remote
 * requests to the local arm, alloc.c:82-83), then REQUIRES the
 * allocation to actually be remote — the reference's ocm_test asserts
 * its remoteness expectations the same way (test/ocm_test.c:97-103).
 * Exit code 0 and "pass:" lines on success, -1/"FAIL:" otherwise. */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include "ocm_client.h"

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr,
            "usage: %s NODEFILE RANK [NBYTES [EXPECT_NNODES [host|device]]]\n",
            argv[0]);
    return -1;
  }
  const char* nodefile = argv[1];
  long rank = strtol(argv[2], NULL, 10);
  unsigned long long n = argc > 3 ? strtoull(argv[3], NULL, 10) : (1u << 20);
  long expect_nnodes = argc > 4 ? strtol(argv[4], NULL, 10) : 0;
  int kind = OCMC_KIND_REMOTE_HOST;
  if (argc > 5) {
    if (strcmp(argv[5], "device") == 0) {
      kind = OCMC_KIND_REMOTE_DEVICE;
    } else if (strcmp(argv[5], "host") != 0) {
      fprintf(stderr, "unknown KIND %s (use 'host' or 'device')\n", argv[5]);
      return -1;
    }
  }

  ocmc_ctx* ctx = ocmc_init(nodefile, rank, 2.0);
  if (!ctx) {
    fprintf(stderr, "FAIL: init: %s\n", ocmc_last_error(NULL));
    return -1;
  }

  if (expect_nnodes > 1) {
    int64_t seen = ocmc_nnodes(ctx);
    for (int i = 0; i < 300 && seen < expect_nnodes; ++i) { /* <= 30 s */
      usleep(100 * 1000);
      seen = ocmc_refresh_nnodes(ctx);
    }
    if (seen < expect_nnodes) {
      fprintf(stderr, "FAIL: cluster never reached %ld nodes (saw %lld)\n",
              expect_nnodes, (long long)seen);
      ocmc_tini(ctx);
      return -1;
    }
    printf("membership: %lld/%ld nodes joined\n", (long long)seen,
           expect_nnodes);
  }

  ocmc_handle h;
  unsigned char *src = NULL, *dst = NULL;
  int rc = -1;
  if (ocmc_alloc(ctx, n, (uint8_t)kind, &h) != 0) {
    fprintf(stderr, "FAIL: alloc: %s\n", ocmc_last_error(ctx));
    goto done;
  }
  printf("alloc id=%llu owner_rank=%lld remote=%d sz=%llu\n",
         (unsigned long long)h.alloc_id, (long long)h.rank,
         ocmc_is_remote(&h), (unsigned long long)ocmc_remote_sz(&h));
  if (ocmc_nnodes(ctx) >= 2) {
    /* A multi-node cluster must serve REMOTE_HOST remotely; a demoted
     * handle here means the join raced the app (ocm_test.c:97-103). */
    if (!ocmc_is_remote(&h) || ocmc_remote_sz(&h) != n) {
      fprintf(stderr, "FAIL: expected a remote allocation on a %lld-node "
              "cluster, got remote=%d sz=%llu\n",
              (long long)ocmc_nnodes(ctx), ocmc_is_remote(&h),
              (unsigned long long)ocmc_remote_sz(&h));
      goto done;
    }
  }

  src = malloc(n);
  dst = malloc(n);
  if (!src || !dst) goto done;
  for (unsigned long long i = 0; i < n; ++i) src[i] = (unsigned char)(i * 2654435761u >> 24);
  memset(dst, 0, n);

  if (ocmc_put(ctx, &h, src, n, 0) != 0) {
    fprintf(stderr, "FAIL: put: %s\n", ocmc_last_error(ctx));
    goto done;
  }
  if (ocmc_get(ctx, &h, dst, n, 0) != 0) {
    fprintf(stderr, "FAIL: get: %s\n", ocmc_last_error(ctx));
    goto done;
  }
  if (memcmp(src, dst, n) != 0) {
    fprintf(stderr, "FAIL: readback mismatch\n");
    goto done;
  }
  printf("pass: %llu-byte remote put/get round trip\n", n);

  /* Staging-window flavor (ocm_localbuf + op_flag semantics,
   * lib.c:425-460,670): mutate the handle's own buffer in place, push it,
   * clobber it, pull it back. */
  {
    unsigned char* stage = (unsigned char*)ocmc_localbuf(ctx, &h);
    if (!stage) {
      fprintf(stderr, "FAIL: localbuf: %s\n", ocmc_last_error(ctx));
      goto done;
    }
    for (unsigned long long i = 0; i < n; ++i)
      stage[i] = (unsigned char)(i * 40503u >> 8);
    if (ocmc_copy_onesided(ctx, &h, 1) != 0) { /* write staging -> remote */
      fprintf(stderr, "FAIL: copy_onesided write: %s\n", ocmc_last_error(ctx));
      goto done;
    }
    memset(stage, 0, n);
    if (ocmc_copy_onesided(ctx, &h, 0) != 0) { /* read remote -> staging */
      fprintf(stderr, "FAIL: copy_onesided read: %s\n", ocmc_last_error(ctx));
      goto done;
    }
    for (unsigned long long i = 0; i < n; ++i) {
      if (stage[i] != (unsigned char)(i * 40503u >> 8)) {
        fprintf(stderr, "FAIL: staging readback mismatch at %llu\n", i);
        goto done;
      }
    }
    printf("pass: localbuf staging round trip\n");
  }

  /* Handle-to-handle copy (ocm_copy host arm, lib.c:502-665). */
  {
    ocmc_handle h2;
    if (ocmc_alloc(ctx, n, (uint8_t)kind, &h2) != 0) {
      fprintf(stderr, "FAIL: alloc2: %s\n", ocmc_last_error(ctx));
      goto done;
    }
    if (ocmc_copy(ctx, &h2, &h, 0) != 0) {
      fprintf(stderr, "FAIL: copy: %s\n", ocmc_last_error(ctx));
      goto done;
    }
    memset(dst, 0, n);
    if (ocmc_copy_out(ctx, dst, &h2, n, 0) != 0) {
      fprintf(stderr, "FAIL: copy_out: %s\n", ocmc_last_error(ctx));
      goto done;
    }
    for (unsigned long long i = 0; i < n; ++i) {
      if (dst[i] != (unsigned char)(i * 40503u >> 8)) {
        fprintf(stderr, "FAIL: copy mismatch at %llu\n", i);
        goto done;
      }
    }
    if (ocmc_free(ctx, &h2) != 0) {
      fprintf(stderr, "FAIL: free2: %s\n", ocmc_last_error(ctx));
      goto done;
    }
    printf("pass: handle-to-handle copy + copy_out\n");
  }

  if (ocmc_free(ctx, &h) != 0) {
    fprintf(stderr, "FAIL: free: %s\n", ocmc_last_error(ctx));
    goto done;
  }
  rc = 0;

done:
  free(src);
  free(dst);
  ocmc_tini(ctx);
  return rc;
}
