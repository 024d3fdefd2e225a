/* ocm_client.h — C API for the oncilla-tpu control/data plane.
 *
 * The analogue of the reference's app-linked library surface
 * (the reference's inc/oncillamem.h: ocm_init/tini/alloc/free/copy...),
 * rebuilt for this framework's wire protocol: a C (or C++/Fortran/...)
 * application links libocm_tpu.so, attaches to its per-host daemon, and
 * allocates / frees / puts / gets disaggregated host memory anywhere in the
 * cluster. Device (HBM) kinds can be allocated and freed — extents are
 * daemon bookkeeping — but their data path needs a JAX/SPMD process, so
 * ocmc_put/ocmc_get on device kinds fail with an error (use the Python
 * binding for HBM arms).
 *
 * All functions return 0 on success and -1 on failure (the reference's
 * convention); ocmc_last_error() describes the most recent failure on the
 * context. Handles are plain structs owned by the caller.
 */

#ifndef OCM_CLIENT_H_
#define OCM_CLIENT_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct ocmc_ctx ocmc_ctx;

/* Wire kind tags (enum ocm_kind analogue, oncillamem.h:26-35). */
enum {
  OCMC_KIND_LOCAL_HOST = 0,
  OCMC_KIND_LOCAL_DEVICE = 1,
  OCMC_KIND_REMOTE_DEVICE = 2,
  OCMC_KIND_REMOTE_HOST = 3,
};

typedef struct {
  uint64_t alloc_id;
  int64_t rank;          /* owner daemon's rank */
  uint32_t device_index; /* device arena index for device kinds */
  uint8_t kind;          /* OCMC_KIND_*; may differ from the requested kind
                            (single-node clusters demote remote kinds) */
  uint64_t nbytes;
  uint64_t offset;       /* extent offset inside the owner's arena */
  char owner_host[256];  /* data-plane address (DCN path) */
  uint32_t owner_port;
} ocmc_handle;

/* Attach to the local daemon named by `nodefile` line `rank`
 * (ocm_init analogue). Returns NULL on failure; ocmc_last_error(NULL)
 * then returns the init error. `heartbeat_s` > 0 starts a lease-renewal
 * thread with that period; pass 0 for no heartbeats. */
ocmc_ctx* ocmc_init(const char* nodefile, int64_t rank, double heartbeat_s);

/* Detach and release the context (ocm_tini analogue). NULL is a no-op. */
void ocmc_tini(ocmc_ctx* ctx);

/* Allocate `nbytes` of kind OCMC_KIND_*; fills *out (ocm_alloc analogue). */
int ocmc_alloc(ocmc_ctx* ctx, uint64_t nbytes, uint8_t kind,
               ocmc_handle* out);

/* Release an allocation (ocm_free analogue). */
int ocmc_free(ocmc_ctx* ctx, const ocmc_handle* h);

/* One-sided write/read of host-kind allocations, chunked + pipelined
 * straight to the owner daemon (ocm_copy_onesided analogue). */
int ocmc_put(ocmc_ctx* ctx, const ocmc_handle* h, const void* buf,
             uint64_t nbytes, uint64_t offset);
int ocmc_get(ocmc_ctx* ctx, const ocmc_handle* h, void* buf, uint64_t nbytes,
             uint64_t offset);

/* ocm_localbuf analogue (lib.c:425-460): the app-side staging window onto
 * an allocation. Lazily allocated (h->nbytes bytes unless
 * ocmc_localbuf_sized created a smaller window first — check
 * ocmc_localbuf_size before writing h->nbytes into it), zero-initialised
 * and owned by the context; stable for the handle's lifetime, released by
 * ocmc_free/ocmc_tini. Mutate it in place, then move it with
 * ocmc_copy_onesided. Returns NULL on failure. */
void* ocmc_localbuf(ocmc_ctx* ctx, const ocmc_handle* h);

/* Size of the handle's staging window: h->nbytes, or the smaller size a
 * prior ocmc_localbuf_sized chose. 0 when no window exists yet. */
uint64_t ocmc_localbuf_size(ocmc_ctx* ctx, const ocmc_handle* h);

/* Asymmetric staging window (the reference's ocm_alloc_params
 * .local_alloc_bytes idiom, test/ocm_test.c:35-47): create the handle's
 * staging buffer at `nbytes` < h->nbytes. Must be called before the
 * full-size window exists; a second call with a different size fails.
 * Move window-sized pieces at explicit remote offsets with
 * ocmc_put/ocmc_get; ocmc_copy_onesided moves the window from offset 0. */
void* ocmc_localbuf_sized(ocmc_ctx* ctx, const ocmc_handle* h,
                          uint64_t nbytes);

/* ocm_copy_onesided analogue (lib.c:670): move the handle's OWN staging
 * buffer (ocmc_localbuf) over the fabric. op_flag = 1 writes the staging
 * buffer into the allocation, op_flag = 0 reads the allocation into it —
 * the reference's op_flag convention. */
int ocmc_copy_onesided(ocmc_ctx* ctx, const ocmc_handle* h, int op_flag);

/* ocm_copy analogue (lib.c:502-665): copy min(src->nbytes, dst->nbytes)
 * bytes (or `nbytes` if nonzero) between two host-kind allocations,
 * streamed through the app in pipeline chunks. */
int ocmc_copy(ocmc_ctx* ctx, const ocmc_handle* dst, const ocmc_handle* src,
              uint64_t nbytes);

/* ocm_copy_out / ocm_copy_in — unimplemented -1 stubs in the reference
 * (lib.c:491-499); working here as named aliases of get/put. */
int ocmc_copy_out(ocmc_ctx* ctx, void* dst, const ocmc_handle* src,
                  uint64_t nbytes, uint64_t offset);
int ocmc_copy_in(ocmc_ctx* ctx, const ocmc_handle* dst, const void* src,
                 uint64_t nbytes, uint64_t offset);

/* ocm_is_remote / ocm_remote_sz analogues (truth table correct; the
 * reference's ocm_is_remote is buggy, lib.c:461). */
int ocmc_is_remote(const ocmc_handle* h);
uint64_t ocmc_remote_sz(const ocmc_handle* h);

/* Number of cluster nodes the daemon reported at CONNECT. */
int64_t ocmc_nnodes(const ocmc_ctx* ctx);

/* Re-query the local daemon's CURRENT membership view (STATUS round
 * trip; on the rank-0 master this is the joined count, not the nodefile
 * size). Updates the value ocmc_nnodes returns. Returns the fresh count,
 * or -1 on error. Poll this before depending on remote placement: a
 * still-joining cluster demotes remote allocation requests to the local
 * arm (alloc.c:82-83 parity). */
int64_t ocmc_refresh_nnodes(ocmc_ctx* ctx);

/* Description of the most recent failure on `ctx`; with ctx == NULL, the
 * most recent ocmc_init failure (process-wide). Valid until the next call
 * on the same context / thread. */
const char* ocmc_last_error(const ocmc_ctx* ctx);

#ifdef __cplusplus
}
#endif

#endif /* OCM_CLIENT_H_ */
